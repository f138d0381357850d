"""Port parity of the ML-II gradient path: the layer tier's arccos backward,
autograd through the port's Cholesky, the fused Gram's two backward
contracts (snngp_torch/ops/gram.py, K2's plain version) and the marginal
NLL ``SPR.loss``, each against the JAX package on the same numpy inputs.

The JAX Pallas kernels run in interpreter mode on the CPU, as
tests/test_torch_gram.py runs them. Tolerances:
- gradients of the fused Gram: rtol 1e-5, the bar of
  tests/test_pallas.py:247-290 (the JAX package's own K2 against autodiff);
- K2's four Grams: 1e-5 of max|dK|, the same bar on a Gram scale;
- ``SPR.loss`` value and gradients: rtol 1e-4, as tests/test_pallas.py:314
  sets it for a loss through an fp32 Cholesky;
- float64 Cholesky gradients: rtol 1e-10 (the same algorithm in float64:
  round-off only).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snngp.ops.pallas.gram as G
from snngp.nn import arch as jarch
from snngp.nn.layers import kernel_fn_of as jkernel_fn_of
from snngp.ops import linalg as jlinalg

from snngp_torch.nn import arch as tarch
from snngp_torch.nn.layers import kernel_fn_of as tkernel_fn_of
from snngp_torch.ops import gram as TG
from snngp_torch.ops import linalg as tlinalg

from _torch_parity import cuda_device, dual_act_inputs, randn, to_numpy, to_torch  # noqa: F401

SCALES = (1.2, 0.3, 0.9)


@pytest.fixture(autouse=True)
def _interpret_mode():
    G.INTERPRET = True
    yield
    G.INTERPRET = False


def _tensors(*values, requires_grad=True, dtype=torch.float32):
    return [torch.tensor(v, dtype=dtype, requires_grad=requires_grad) for v in values]


def _jax_layer(mode):
    return jarch.get_mlp_layer if mode == "mlp" else jarch.get_dense_resnet_layer


def _torch_layer(mode):
    return tarch.get_mlp_layer if mode == "mlp" else tarch.get_dense_resnet_layer


def _torch_gram(mode):
    return TG.mlp_gram if mode == "mlp" else TG.resnet_gram


def _jax_gram(mode):
    return G.mlp_gram if mode == "mlp" else G.resnet_gram


# -- repair 1: finite ReLU Gram gradients on K(x, x) ---------------------------------

@pytest.mark.parametrize("path", ["layer tier", "fused, trainable inputs",
                                  "fused, scalar tangents"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_relu_gram_grads_on_the_diagonal_are_finite_and_match_jax(mode, path):
    # The diagonal of K(x, x) is c = 1, where autograd through acos is NaN.
    (x,) = randn(20, (50, 5))

    def f_jax(w, b):
        kfn = jkernel_fn_of(_jax_layer(mode)(3, 1, "relu", w, b, 1.0))
        return jnp.sum(kfn(x, x, get="nngp"))

    want = jax.grad(f_jax, argnums=(0, 1))(1.1, 0.25)
    w, b = _tensors(1.1, 0.25)
    xt = to_torch(x)
    if path == "layer tier":
        k = tkernel_fn_of(_torch_layer(mode)(3, 1, "relu", w, b, 1.0))(xt, xt)
    else:
        k = _torch_gram(mode)(xt, xt, depth=3, act="relu", w_std=w, b_std=b, last_w_std=1.0,
                              trainable_inputs=path == "fused, trainable inputs")
    got = torch.autograd.grad(k.sum(), (w, b))
    for g, ref in zip(got, want):
        assert torch.isfinite(g)
        np.testing.assert_allclose(float(g), float(ref), rtol=1e-5)


# -- repair 2: autograd through the port's Cholesky ----------------------------------

def test_cholesky_quad_form_and_logdet_grads_match_jax_float64():
    rng = np.random.RandomState(21)
    a = rng.randn(40, 40)
    spd = a @ a.T / 40 + 0.5 * np.eye(40)
    y = rng.randn(40)

    def f_jax(m):
        chol = jnp.linalg.cholesky(m)
        return jlinalg.chol_quad_form(chol, y) + jlinalg.chol_logdet(chol)

    with jax.enable_x64(True):
        want = np.asarray(jax.grad(f_jax)(jnp.asarray(spd)))
        want_val = float(f_jax(jnp.asarray(spd)))
    m = torch.tensor(spd, requires_grad=True)
    chol = tlinalg.cholesky(m)
    val = tlinalg.chol_quad_form(chol, torch.tensor(y)) + tlinalg.chol_logdet(chol)
    (got,) = torch.autograd.grad(val, m)
    np.testing.assert_allclose(val.item(), want_val, rtol=1e-10)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-10, atol=1e-12)


def test_cholesky_failure_marker_under_autograd_and_inference():
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], requires_grad=True)
    chol = tlinalg.cholesky(bad)
    assert torch.isnan(tlinalg.chol_logdet(chol))
    with torch.inference_mode():
        assert torch.isnan(torch.diagonal(tlinalg.cholesky(bad.detach()))).all()


def test_mvn_logpdf_matches_jax():
    rng = np.random.RandomState(22)
    a = rng.randn(30, 30).astype(np.float32)
    cov = (a @ a.T / 30 + np.eye(30)).astype(np.float32)
    y = rng.randn(30).astype(np.float32)
    want = float(jlinalg.mvn_logpdf(jnp.asarray(y), jnp.asarray(cov)))
    got = float(tlinalg.mvn_logpdf(to_torch(y), to_torch(cov)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- the fused Gram's backward ----------------------------------------------------------

def _k2_inputs(mode, act, x1, x2, depth=3):
    w, b, last = (torch.tensor(v, device=x1.device) for v in SCALES)
    v1s, dv1s = TG._stack_with_tangents(mode, x1, depth, act, w, b)
    v2s, dv2s = ((v1s, dv1s) if x2 is x1
                 else TG._stack_with_tangents(mode, x2, depth, act, w, b))
    scales = torch.stack([w * w, b * b, last * last,
                          torch.tensor(1.0 / x1.shape[1], device=x1.device), w, b, last])
    return x1, x2, v1s, v2s, dv1s, dv2s, scales


@pytest.mark.parametrize("shape", ["cross", "symmetric"])
@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_gram_tangents_plain_matches_pallas_grad_kernel(mode, act, shape):
    # 140 x 6 vs 90 x 6: ragged against the Pallas 128-row tiles.
    x1, x2 = randn(23, (140, 6), (90, 6))
    if shape == "symmetric":
        x2 = x1
    want = G._mlp_gram_grads(3, act, (128, 128), mode, jnp.asarray(x1), jnp.asarray(x2),
                             *SCALES)
    a = to_torch(x1)
    b = a if shape == "symmetric" else to_torch(x2)
    got = TG.gram_tangents_plain(*_k2_inputs(mode, act, a, b), depth=3, act=act, mode=mode)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(to_numpy(g), w, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_gram_grads_plain_on_kxx_equals_the_folded_sum(mode, act):
    """K2's symmetric launch runs each pair j <= i of K(x, x) once, weighted
    by g[i, j] + g[j, i] (g[i, i] on the diagonal). On a cotangent that is
    not symmetric, the JAX kernel's tangent Grams give the same sums folded
    as over all pairs (in float64: dK is symmetric up to fp32 round-off),
    and K2's plain version gives them within 1e-5 of sum |g dK|."""
    x, cot = randn(41, (140, 6), (140, 140))
    grams = G._mlp_gram_grads(3, act, (128, 128), mode, jnp.asarray(x), jnp.asarray(x),
                              *SCALES)
    g = cot.astype(np.float64)
    lower, diag = np.tril_indices(140, -1), np.arange(140)
    folded, full, scale = [], [], []
    for dk in (np.asarray(t, dtype=np.float64) for t in grams[1:]):
        folded.append(np.sum((g[lower] + g.T[lower]) * dk[lower]) + np.sum(g[diag, diag]
                                                                         * dk[diag, diag]))
        full.append(np.sum(g * dk))
        scale.append(np.sum(np.abs(g * dk)))
    xt = to_torch(x)
    got = to_numpy(TG.gram_grads_plain(*_k2_inputs(mode, act, xt, xt), to_torch(cot), depth=3,
                                       act=act, mode=mode))
    np.testing.assert_allclose(folded, full, rtol=0, atol=1e-5 * min(scale))
    np.testing.assert_allclose(got, folded, rtol=0, atol=1e-5 * min(scale))


@pytest.mark.parametrize("act", ["relu", "erf"])
def test_per_row_factor_partials_match_jax(act):
    """K2's per-row factor form of the partials, written out here as
    csrc/gram.cu computes them, against the JAX package's _relu_t_partials /
    _erf_t_partials in fp32, each within 1e-6 of its largest magnitude: T,
    T_k and the tangents' sum T_v1 dv1 + T_v2 dv2, with the rows' tangents
    staged scaled (relu r dv: sin(theta) / (4 pi) (a_j r_i dv_i + a_i r_j
    dv_j), sin(theta) by rsqrt; erf e^2 dv: -T' g (e_i^2 dv_i + e_j^2
    dv_j), T' by rsqrt). A
    row of zero variance has zero tangents, as its variance recursion
    gives at b_std = 0, so its singular T_v is not compared."""
    k, v1, v2 = dual_act_inputs(act, 42)
    (dv1, dv2) = randn(43, k.shape, k.shape)
    dv1[v1 == 0], dv2[v2 == 0] = 0.0, 0.0
    kt, v1t, v2t, d1t, d2t = to_torch(k, v1, v2, dv1, dv2)
    if act == "relu":
        a1, a2 = (torch.sqrt(torch.clamp(v, min=1e-30)) for v in (v1t, v2t))
        r1, r2 = 1.0 / a1, 1.0 / a2
        c = torch.clamp(kt * (r1 * r2), -1.0, 1.0)
        theta = torch.acos(c)
        s2 = torch.clamp(1.0 - c * c, min=0.0)
        sin_t = torch.where(s2 > 0.0, s2 * torch.rsqrt(s2), 0.0)
        t = (a1 * a2 * sin_t + (math.pi - theta) * kt) * (0.5 / math.pi)
        tk = (math.pi - theta) * (0.5 / math.pi)
        tv = sin_t * (0.25 / math.pi) * (a2 * (r1 * d1t) + a1 * (r2 * d2t))
        want = G._relu_t_partials(k, v1, v2)
    else:
        e1, e2 = (1.0 / torch.sqrt(1.0 + 2.0 * v) for v in (v1t, v2t))
        r = e1 * e2
        g = 2.0 * kt * r
        c = torch.clamp(g, -1.0, 1.0)
        base = torch.where((g > -1.0) & (g < 1.0),
                           (2.0 / math.pi) * torch.rsqrt(torch.clamp(1.0 - c * c, min=1e-30)),
                           0.0)
        t = (2.0 / math.pi) * torch.asin(c)
        tk = base * (2.0 * r)
        tv = -(base * g) * (d1t / (1.0 + 2.0 * v1t) + d2t / (1.0 + 2.0 * v2t))
        want = G._erf_t_partials(k, v1, v2)
    jt, jtk, jtv1, jtv2 = (np.asarray(w) for w in want)
    jtv = jtv1 * dv1 + jtv2 * dv2
    for got, ref in ((t, jt), (tk, jtk), (tv, jtv)):
        np.testing.assert_allclose(to_numpy(got), ref, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("other", ["x", "v", "dv"])
def test_gram_grads_cuda_refuses_same_for_two_operands(other):
    """K2's same=True runs each pair j <= i once, so the wrapper takes it
    only when x2, v2s and dv2s are x1's, v1s and dv1s (checked before the
    device)."""
    (x,) = randn(44, (8, 3))
    a = to_torch(x)
    _, _, v, _, dv, _, scales = _k2_inputs("mlp", "relu", a, a)
    ops = dict(x=(a, a), v=(v, v), dv=(dv, dv))
    ops[other] = (ops[other][0], ops[other][0].clone())
    with pytest.raises(ValueError, match=f"same=True.*{other}2 is not {other}1"):
        TG.gram_grads_cuda(*ops["x"], *ops["v"], *ops["dv"], scales, torch.ones(8, 8),
                           depth=3, act="relu", mode="mlp", same=True)


def test_gram_grads_plain_contracts_in_float64():
    x1, x2, cot = randn(24, (30, 4), (20, 4), (30, 20))
    args = _k2_inputs("mlp", "relu", to_torch(x1), to_torch(x2))
    sums = TG.gram_grads_plain(*args, to_torch(cot), depth=3, act="relu", mode="mlp")
    _, dkw, dkb, dkl = TG.gram_tangents_plain(*args, depth=3, act="relu", mode="mlp")
    want = [np.sum(cot.astype(np.float64) * to_numpy(t).astype(np.float64))
            for t in (dkw, dkb, dkl)]
    assert sums.dtype == torch.float64
    np.testing.assert_allclose(to_numpy(sums), want, rtol=1e-12)


@pytest.mark.parametrize("trainable_inputs", [False, True])
@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_fused_gram_grads_match_jax(mode, act, trainable_inputs):
    # A cotangent of mean 1: a zero-mean one cancels the sums down to where
    # fp32 reassociation between the two frameworks exceeds 1e-5 of them.
    x1, x2, noise = randn(25, (140, 6), (130, 6), (140, 130))
    cot = 1.0 + 0.5 * noise

    def f_jax(a, b, w, bs, last):
        k = _jax_gram(mode)(a, b, depth=2, act=act, w_std=w, b_std=bs, last_w_std=last,
                            tile=(128, 128), trainable_inputs=trainable_inputs)
        return jnp.sum(cot * k)

    want = jax.grad(f_jax, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x1), jnp.asarray(x2),
                                                     *SCALES)
    a, b = (t.requires_grad_() for t in to_torch(x1, x2))
    w, bs, last = _tensors(*SCALES)
    k = _torch_gram(mode)(a, b, depth=2, act=act, w_std=w, b_std=bs, last_w_std=last,
                          trainable_inputs=trainable_inputs)
    got = torch.autograd.grad((to_torch(cot) * k).sum(), (a, b, w, bs, last))
    for g, ref in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(g), float(ref), rtol=1e-5)
    for g, ref in zip(got[:2], want[:2]):
        ref = np.asarray(ref)
        if not trainable_inputs:
            assert not np.any(ref) and not torch.any(g)   # zero by contract
        np.testing.assert_allclose(to_numpy(g), ref, atol=1e-5 * max(np.abs(ref).max(), 1e-30))


def test_scalar_tangent_backward_gives_no_x_cotangent_unless_asked():
    (x,) = randn(26, (40, 3))
    xt = to_torch(x)
    w, b, last = _tensors(*SCALES)
    k = TG.mlp_gram(xt, xt, depth=2, w_std=w, b_std=b, last_w_std=last,
                    trainable_inputs=False)
    k.sum().backward()
    assert xt.grad is None and all(torch.isfinite(t.grad) for t in (w, b, last))


def test_gram_grads_cuda_rejects_cpu_tensors():
    x1, x2, cot = randn(27, (8, 3), (8, 3), (8, 8))
    args = _k2_inputs("mlp", "relu", to_torch(x1), to_torch(x2))
    before = dict(TG.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        TG.gram_grads_cuda(*args, to_torch(cot), depth=3, act="relu", mode="mlp")
    with pytest.raises(KeyError):
        TG.gram_grads_cuda(*args, to_torch(cot), depth=3, act="tanh", mode="mlp")
    assert TG.LAUNCHES == before


def test_gram_grads_kernel_matches_plain_version(cuda_device):
    # K2 against its plain version on the card: the chip_smoke.py bar,
    # |s_kernel - s_plain| <= 1e-5 sum |g dK|. Runs only where a card is.
    x1, x2, cot = randn(28, (301, 11), (77, 11), (301, 77))
    with torch.inference_mode():
        args = [t.to(cuda_device) for t in _k2_inputs("resnet", "erf", *to_torch(x1, x2))]
        g = to_torch(cot).to(cuda_device)
        kw = dict(depth=3, act="erf", mode="resnet")
        got = TG.gram_grads_cuda(*args, g, **kw)
        want = TG.gram_grads_plain(*args, g, **kw)
        _, *tangents = TG.gram_tangents_plain(*args, **kw)
        scale = torch.stack([(g.double() * t.double()).abs().sum() for t in tangents])
    assert ((got - want).abs() / scale).max().item() <= 1e-5


@pytest.mark.parametrize("n", [1, 63, 64, 65, 301])
@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_gram_grads_kernel_symmetric_launch(cuda_device, mode, act, n):
    # K2's symmetric launch on a cotangent that is not symmetric: within
    # 1e-5 of sum |g dK| of the plain all-pairs sums, bitwise repeatable,
    # and the same bits for g and g^T (each pair's weight g[i, j] + g[j, i]).
    x, cot = randn(50 + n, (n, 11), (n, n))
    with torch.inference_mode():
        a = to_torch(x).to(cuda_device)
        args = _k2_inputs(mode, act, a, a, depth=4)
        g = to_torch(cot).to(cuda_device)
        kw = dict(depth=4, act=act, mode=mode)
        got = TG.gram_grads_cuda(*args, g, **kw, same=True)
        again = TG.gram_grads_cuda(*args, g, **kw, same=True)
        transposed = TG.gram_grads_cuda(*args, g.T.contiguous(), **kw, same=True)
        want = TG.gram_grads_plain(*args, g, **kw)
        _, *tangents = TG.gram_tangents_plain(*args, **kw)
        scale = torch.stack([(g.double() * t.double()).abs().sum() for t in tangents])
    assert torch.equal(got, again) and torch.equal(got, transposed)
    assert ((got - want).abs() / scale).max().item() <= 1e-5


@pytest.mark.parametrize("same", [False, True], ids=["cross", "symmetric"])
@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_gram_grads_kernel_deep(cuda_device, mode, act, same):
    # Depth 20: the row factors are staged in three passes of 8 layers.
    x1, x2, cot = randn(60, (130, 6), (70, 6), (130, 130))
    with torch.inference_mode():
        a, b = (t.to(cuda_device) for t in to_torch(x1, x2))
        args = _k2_inputs(mode, act, a, a if same else b, depth=20)
        g = to_torch(cot if same else cot[:, :70].copy()).to(cuda_device)
        kw = dict(depth=20, act=act, mode=mode)
        got = TG.gram_grads_cuda(*args, g, **kw, same=same)
        want = TG.gram_grads_plain(*args, g, **kw)
        _, *tangents = TG.gram_tangents_plain(*args, **kw)
        scale = torch.stack([(g.double() * t.double()).abs().sum() for t in tangents])
    assert ((got - want).abs() / scale).max().item() <= 1e-5


# -- SPR.loss ------------------------------------------------------------------------

# eps = 0.1: at 1e-2 the condition number of K + eps I amplifies the two
# frameworks' fp32 Gram round-off (~1e-7) past 1e-4 on the smallest of the
# six gradients (~0.007 against O(1) for the others).
_CFG = dict(num_hiddens=2, activation="relu", w_std=1.2, b_std=0.3, last_w_std=0.9,
            alpha=2.0, beta=1.5, epsilon=0.1)


def _jax_model(method, network, x, y):
    from snngp.cli.regression import _build_model
    cfg = dict(_CFG, network=network, method=method)
    return _build_model(cfg, jnp.asarray(x), jnp.asarray(y), 0.0, 1.0)[0]


def _torch_model(method, network, x, y):
    from snngp_torch.cli.regression import _build_model
    cfg = dict(_CFG, network=network, method=method)
    return _build_model(cfg, to_torch(x), to_torch(y), 0.0, 1.0)[0]


@pytest.mark.parametrize("network", ["mlp", "resnet"])
@pytest.mark.parametrize("method", ["gp", "tp"])
def test_spr_loss_and_grads_match_jax(method, network):
    x, y = randn(29, (60, 4), (60,))
    jmodel = _jax_model(method, network, x, y)
    params = jmodel.init_params()
    want_val, want_grads = jax.value_and_grad(jmodel.loss)(params)
    from snngp.models.params import named_leaves as jnamed
    want = dict(jnamed(want_grads))

    tmodel = _torch_model(method, network, x, y)
    loss = tmodel.loss()
    loss.backward()
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(loss.item(), float(want_val), rtol=1e-4)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-4,
                                   err_msg=name)
