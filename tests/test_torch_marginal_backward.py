"""The closed-form backward of the marginal log-densities
(``snngp_torch.ops.linalg.quad_logdet``): S^-1 from the factor by halves
(``inverse_from_factor``) against a float64 inverse; the gradients of
(q, log det S) and of both marginals against finite differences and against
autograd through the factor (the ``chol_fn=cholesky`` route, which keeps
it); the loss bit for bit as that route gives it; NaN and no error where S
is not PD; the count of closed-form backwards on ``SPR.loss`` and on the
``chol_fn`` route; and, on the card, ``SPR.loss``'s gradient at N = 4,096
against float64 with no triangular solve against N right-hand sides in its
backward. No JAX: the reference is the port's autograd route.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from snngp_torch.models import SPR, NNGPKernel, GaussianLikelihood, StudentTLikelihood
from snngp_torch.nn import arch, layers
from snngp_torch.ops import linalg as L
from snngp_torch.ops.mvt import multivariate_t_logpdf

from _torch_parity import cuda_device  # noqa: F401


def _spd(n, seed, dtype=torch.float64, ridge=0.5):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(n, n, generator=gen, dtype=dtype)
    return a @ a.mT / n + ridge * torch.eye(n, dtype=dtype)


# -- S^-1 by halves -------------------------------------------------------------------

# (N, block): below one block; ragged (a last block of 5, 8 and 60); exact
# multiples of the block (128 = 8 x 16, 1,024 = 2 x 512, the block it runs at).
@pytest.mark.parametrize("n,block", [(40, 512), (37, 8), (200, 16), (700, 64), (128, 16),
                                     (1024, 512)])
def test_inverse_from_factor_matches_a_float64_inverse(n, block, monkeypatch):
    monkeypatch.setattr(L, "_BLOCK", block)
    s = _spd(n, seed=n)
    got = L.inverse_from_factor(torch.linalg.cholesky(s))
    want = torch.linalg.inv(s)
    assert torch.equal(got, got.mT)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12 * want.abs().max())


def test_inverse_from_factor_of_a_failed_factor_is_nan():
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(L.inverse_from_factor(L.cholesky(bad))).all()


# -- gradients ----------------------------------------------------------------------------

@pytest.fixture
def small_block(monkeypatch):
    """Blocks of 3, so a backward at N = 10 takes four block columns, the
    last of one row."""
    monkeypatch.setattr(L, "_BLOCK", 3)


def _inputs(n=10, seed=4):
    gen = torch.Generator().manual_seed(seed)
    s = _spd(n, seed, ridge=1.0).requires_grad_()
    x = torch.randn(n, generator=gen, dtype=torch.float64).requires_grad_()
    loc = (0.3 * torch.randn(n, generator=gen, dtype=torch.float64)).requires_grad_()
    df = torch.tensor(3.5, dtype=torch.float64, requires_grad=True)
    return s, x, loc, df


def _autograd_route(fn):
    """``fn`` with the factorization handed in: autograd through it."""
    if fn is L.quad_logdet:
        def route(s, r):
            chol = L.cholesky(s)
            return L.chol_quad_form(chol, r), L.chol_logdet(chol)
        return route
    if fn is L.mvn_logpdf:
        return lambda y, cov: L.mvn_logpdf(y, cov, chol_fn=L.cholesky)
    return lambda x, loc, s, df: multivariate_t_logpdf(x, loc, s, df, chol_fn=L.cholesky)


def _cases():
    s, x, loc, df = _inputs()
    return {"quad_logdet": (L.quad_logdet, (s, x - loc.detach())),
            "mvn_logpdf": (L.mvn_logpdf, (x, s)),
            "multivariate_t_logpdf": (multivariate_t_logpdf, (x, loc, s, df))}


@pytest.mark.parametrize("case", ["quad_logdet", "mvn_logpdf", "multivariate_t_logpdf"])
def test_closed_form_passes_gradcheck_in_float64(case, small_block):
    fn, args = _cases()[case]
    leaves = tuple(a.detach().requires_grad_() for a in args)
    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("case", ["quad_logdet", "mvn_logpdf", "multivariate_t_logpdf"])
def test_closed_form_gradients_match_autograd_through_the_factor(case, small_block):
    fn, args = _cases()[case]
    leaves = [a.detach().requires_grad_() for a in args]
    got_val = fn(*leaves)
    got_val = got_val if isinstance(got_val, tuple) else (got_val,)
    got = torch.autograd.grad(sum(got_val), leaves)
    leaves = [a.detach().requires_grad_() for a in args]
    want_val = _autograd_route(fn)(*leaves)
    want_val = want_val if isinstance(want_val, tuple) else (want_val,)
    want = torch.autograd.grad(sum(want_val), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("block", [512, 64])
def test_the_gradient_in_s_is_symmetric_bit_for_bit(block, monkeypatch):
    monkeypatch.setattr(L, "_BLOCK", block)
    s, x, loc, _ = (t.detach().float() for t in _inputs(n=300, seed=9))
    s.requires_grad_()
    (g,) = torch.autograd.grad(sum(L.quad_logdet(s, x - loc)), s)
    assert torch.equal(g, g.mT)


@pytest.mark.parametrize("marginal", ["mvn_logpdf", "multivariate_t_logpdf"])
def test_the_loss_is_the_autograd_routes_bit_for_bit_in_float32(marginal):
    s, x, loc, df = (t.detach().float() for t in _inputs(n=300, seed=9))
    if marginal == "mvn_logpdf":
        got, want = L.mvn_logpdf(x, s), L.mvn_logpdf(x, s, chol_fn=L.cholesky)
    else:
        got = multivariate_t_logpdf(x, loc, s, df)
        want = multivariate_t_logpdf(x, loc, s, df, chol_fn=L.cholesky)
    assert got.item() == want.item()


@pytest.mark.parametrize("marginal", ["mvn_logpdf", "multivariate_t_logpdf"])
def test_a_matrix_that_is_not_pd_gives_nan_loss_and_gradients(marginal):
    s = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]], requires_grad=True)
    x, df = torch.ones(3, requires_grad=True), torch.tensor(3.0, requires_grad=True)
    if marginal == "mvn_logpdf":
        val, leaves = L.mvn_logpdf(x, s), (s, x)
    else:
        val, leaves = multivariate_t_logpdf(x, torch.zeros(3), s, df), (s, x, df)
    assert torch.isnan(val)
    for g in torch.autograd.grad(val, leaves):
        assert torch.isnan(g).all()


# -- where it engages -------------------------------------------------------------------

def _spr(likelihood, n=24, seed=5):
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(n, 3).astype(np.float32))
    y = torch.as_tensor(rng.randn(n).astype(np.float32))

    def kernel_fn(w, b, last):
        return arch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b, last_w_std=last,
                                   trainable_inputs=False)

    return SPR(NNGPKernel(kernel_fn, 1.0, 0.1, 1.0), likelihood, x, y, 0.0, 1.0, eps=1e-2)


@pytest.mark.parametrize("likelihood", ["gp", "tp"])
def test_each_spr_loss_backward_takes_the_closed_form_once(likelihood):
    model = _spr(GaussianLikelihood() if likelihood == "gp" else StudentTLikelihood(2.0, 2.0))
    before = L.BACKWARDS["marginal"]
    for k in range(1, 4):
        model.zero_grad()
        model.loss().backward()
        assert L.BACKWARDS["marginal"] == before + k
        assert all(torch.isfinite(p.grad) for p in model.parameters())


def test_the_chol_fn_route_keeps_autograd_through_its_factor():
    from snngp_torch.parallel.cholesky import blocked_cholesky

    closed = _spr(StudentTLikelihood(2.0, 2.0))
    blocked = _spr(StudentTLikelihood(2.0, 2.0, chol_fn=lambda m: blocked_cholesky(m, block=8)))
    before = L.BACKWARDS["marginal"]
    loss = blocked.loss()
    loss.backward()
    assert L.BACKWARDS["marginal"] == before
    closed_loss = closed.loss()
    closed_loss.backward()
    np.testing.assert_allclose(loss.item(), closed_loss.item(), rtol=1e-5)
    for (name, p), q in zip(blocked.named_parameters(), closed.parameters()):
        np.testing.assert_allclose(p.grad.item(), q.grad.item(), rtol=2e-3, atol=1e-6,
                                   err_msg=name)


def _solve_rhs_columns(prof):
    """The right-hand-side columns of every triangular solve in a capture."""
    return [e.input_shapes[1][-1] for e in prof.events()
            if e.name == "aten::linalg_solve_triangular" and len(e.input_shapes) > 1
            and e.input_shapes[1]]


@pytest.mark.parametrize("route", ["closed form", "autograd"])
def test_the_backward_solves_against_no_n_right_hand_sides(route, small_block):
    n = 40
    chol_fn = L.cholesky if route == "autograd" else None
    model = _spr(StudentTLikelihood(2.0, 2.0, chol_fn=chol_fn), n=n)
    loss = model.loss()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        loss.backward()
    columns = _solve_rhs_columns(prof)
    if route == "autograd":
        assert max(columns) == n       # the two solves of autograd's Cholesky backward
    else:
        assert columns and max(columns) <= L._BLOCK < n


# -- on the card ------------------------------------------------------------------------

def _card_spr(likelihood, dtype, device, n=4096, d=16):
    gen = torch.Generator().manual_seed(22)
    x = torch.randn(n, d, generator=gen, dtype=torch.float64)
    u = torch.randn(d, generator=gen, dtype=torch.float64) / math.sqrt(d)
    y = torch.sin(2.0 * x @ u) + 0.5 * torch.cos(x[:, 0]) + 0.1 * torch.randn(
        n, generator=gen, dtype=torch.float64)
    y = (y - y.mean()) / y.std()

    def kernel_fn(w, b, last):
        return layers.kernel_fn_of(arch.get_mlp_layer(4, 1, "relu", w, b, last))

    model = SPR(NNGPKernel(kernel_fn, 1.3, 0.3, 1.0), likelihood, x, y, 0.0, 1.0, eps=1e-2)
    return model.to(device=device, dtype=dtype)


def _card_grads(chol_fn, dtype, device):
    model = _card_spr(StudentTLikelihood(2.0, 2.0, chol_fn=chol_fn), dtype, device)
    gram = model._gram(model.kernel.get_kernel_fn())
    loss = model.loss(gram)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        loss.backward()
        torch.cuda.synchronize()
    grads = torch.stack([p.grad.double() for _, p in sorted(model.named_parameters())])
    return loss.item(), grads.cpu(), prof


def test_cuda_spr_loss_gradient_matches_float64_without_n_column_solves(cuda_device):
    _, want, _ = _card_grads(L.cholesky, torch.float64, cuda_device)
    loss, got, prof = _card_grads(None, torch.float32, cuda_device)
    loss_ag, autograd, _ = _card_grads(L.cholesky, torch.float32, cuda_device)
    assert loss == loss_ag
    err = float((got - want).norm() / want.norm())
    err_ag = float((autograd - want).norm() / want.norm())
    print(f"SPR.loss gradient at N = 4096 against float64: closed form {err:.3e}, "
          f"autograd through the factor {err_ag:.3e}")
    assert err <= 2.0 * max(err_ag, 1e-6)
    columns = _solve_rhs_columns(prof)
    assert columns and max(columns) <= L._BLOCK
