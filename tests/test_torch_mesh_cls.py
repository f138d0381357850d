"""Port parity of the classification side of the mesh, model level:
``inv_psd(chol_fn=)``, ``SVSP(chol_fn=)`` / ``SVSP(mesh=)`` (the blocked
factorization in place of the eigh pseudo-inverse), ``fit_svsp`` with a
``chol_fn``, the batch-sharded ELBO (``SVSP.loss(..., mesh=)``) and
``myrtle_gram_sharded``, each against the JAX package on the same numpy
inputs. The port's meshes are shards of the CPU; the JAX package's are its
8-device CPU mesh (tests/conftest.py).

Random draws: the port is fed the standard variates JAX drew from the same
key (as tests/test_torch_svsp.py does).

Tolerances:
- ``inv_psd``, the SVSP losses and NLLs, ``fit_svsp``'s state: rtol 1e-5
  (fp32 round-off through a blocked factorization of a 16 x 16 inducing
  Gram regularized by eps = 1e-4); correct counts exactly;
- the batch-sharded ELBO against the port unsharded: the loss rtol 1e-6
  (the same pairs in row panels; products of other shapes); against the
  JAX package's ELBO on a batch sharded over 4 devices: the loss rtol 1e-5
  (tests/test_torch_svsp.py's bar); the gradients, both, rtol 1e-4 with an
  atol of 1e-6 of the largest gradient entry of any parameter. A
  per-parameter atol does not hold for the WideResNet's d/db_std (1.2e-4
  against d/dw_std's 1.9, a cancelled sum): JAX's jitted and eager ELBOs
  alone differ there by 3e-4 relative;
- ``myrtle_gram_sharded`` against the JAX full tier: rtol 2e-5 / atol
  1e-6, the bar of tests/test_myrtle_pallas.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random
from jax.sharding import NamedSharding, PartitionSpec

from snngp.models import SVSP as JSVSP, NNGPKernel as JK, GaussianPrior as JG
from snngp.models import InverseGammaPrior as JI
from snngp.models.params import named_leaves as jnamed
from snngp.models.predictor import fit_svsp as jfit_svsp
from snngp.nn import arch as jarch
from snngp.nn.full import get_myrtle_kernel as jfull_myrtle
from snngp.ops import linalg as jlinalg
from snngp.parallel import get_mesh as jget_mesh
from snngp.parallel.cholesky import blocked_cholesky as jblocked

from snngp_torch.models import SVSP as TSVSP, NNGPKernel as TK, GaussianPrior as TG
from snngp_torch.models import InverseGammaPrior as TI
from snngp_torch.models.params import from_jax_named
from snngp_torch.models.predictor import fit_svsp as tfit_svsp
from snngp_torch.nn import arch as tarch
from snngp_torch.ops import linalg as tlinalg
from snngp_torch.ops.mvt import TDraws
from snngp_torch.ops.myrtle_gram import myrtle_gram_sharded
from snngp_torch.parallel import get_mesh
from snngp_torch.parallel.cholesky import blocked_cholesky
from snngp_torch.parallel.mesh import gather

from _torch_parity import to_numpy, to_torch

NI, NB, C, S = 16, 24, 3, 6        # tests/test_parallel.py:223-252's shapes


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=rtol, atol=atol)


def _draws(method, params, key, shape):
    if method == "svgp":
        return to_torch(np.asarray(random.normal(key, shape)))
    a = jax.nn.softplus(params["prior"]["a"])
    key_n, key_g = random.split(key)
    return TDraws(to_torch(np.asarray(random.normal(key_n, shape))),
                  to_torch(np.asarray(random.gamma(key_g, a, shape))))


def _load(jm, tm, rng):
    """Random q_mu / q_sqrt in the JAX parameters, loaded into the port's."""
    params = jm.init_params()
    params["q_mu"] = jnp.asarray(0.3 * rng.randn(C, jm.num_inducing).astype(np.float32))
    params["q_sqrt"] = params["q_sqrt"] + jnp.asarray(
        0.2 * rng.randn(C, jm.num_inducing).astype(np.float32))
    tm.load_state_dict(from_jax_named(jax.tree.map(np.asarray, params)))
    return params


# -- inv_psd and SVSP(chol_fn=, mesh=) ---------------------------------------------------

def test_inv_psd_through_a_chol_fn_matches():
    rng = np.random.RandomState(3)
    a = rng.randn(20, 20).astype(np.float32)
    mat = a @ a.T / 20 + 0.1 * np.eye(20, dtype=np.float32)
    want = jlinalg.inv_psd(mat, chol_fn=lambda m: jblocked(m, block=8))
    got = tlinalg.inv_psd(to_torch(mat), chol_fn=functools.partial(blocked_cholesky, block=8))
    _close(got, want, atol=1e-5 * np.abs(np.asarray(want)).max())
    _close(got, tlinalg.inv_psd(to_torch(mat)), atol=1e-5 * np.abs(np.asarray(want)).max())


def _mlp_models(method, kw, kernel_wrap=None, seed=9):
    """tests/test_parallel.py's SVSP (MLP depth 2, 3 classes, eps 1e-4) in
    both packages, with the constructor arguments ``kw("jax")`` and
    ``kw("torch")``."""
    rng = np.random.RandomState(seed)
    z = rng.randn(NI, 5).astype(np.float32)
    x = rng.randn(NB, 5).astype(np.float32)
    y = rng.randint(C, size=NB)
    wrap = kernel_wrap or (lambda kfn, lib: kfn)

    def jk(w, b, l):
        return wrap(jarch.get_mlp_kernel(2, C, "relu", w_std=w, b_std=b, last_w_std=l), jnp)

    def tk(w, b, l):
        return wrap(tarch.get_mlp_kernel(2, C, "relu", w_std=w, b_std=b, last_w_std=l), torch)

    jp, tp = (JG(), TG()) if method == "svgp" else (JI(2.0, 2.0), TI(2.0, 2.0))
    jm = JSVSP(jp, JK(jk, 1.0, 0.3, 1.0), z, num_latent_gps=C, eps=1e-4, **kw("jax"))
    tm = TSVSP(tp, TK(tk, 1.0, 0.3, 1.0), z, num_latent_gps=C, eps=1e-4, **kw("torch"))
    params = _load(jm, tm, rng)
    return jm, tm, params, x, y


CHOL = {"chol_fn": lambda lib: dict(chol_fn=(lambda m: jblocked(m, block=8)) if lib == "jax"
                                    else functools.partial(blocked_cholesky, block=8)),
        "mesh": lambda lib: dict(mesh=jget_mesh(8) if lib == "jax"
                                 else get_mesh(8, device="cpu"), chol_block=8)}


@pytest.mark.parametrize("method", ["svgp", "svtp"])
@pytest.mark.parametrize("route", list(CHOL))
def test_svsp_with_a_chol_fn_matches(method, route):
    jm, tm, params, x, y = _mlp_models(method, CHOL[route])
    assert tm.chol_fn is not None
    if route == "mesh":
        assert tm.chol_fn.func is blocked_cholesky and tm.chol_fn.keywords == {"block": 8}
    key = random.PRNGKey(0)
    (want, want_grads) = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, key, x, y, 100, S)))(params)
    got = tm.loss(to_torch(x), torch.as_tensor(y), 100, S,
                  draws=_draws(method, params, key, (S, C, NB)))
    got.backward()
    _close(got, want)
    wg = dict(jnamed(want_grads))
    for name, p in tm.named_parameters():
        _close(p.grad, wg[name], rtol=1e-4, atol=1e-5 * np.abs(np.asarray(wg[name])).max())
    want_nll, want_cc = jm.test_acc_nll(params, key, x, y, 8)
    with torch.no_grad():
        got_nll, got_cc = tm.test_acc_nll(to_torch(x), torch.as_tensor(y), 8,
                                          draws=_draws(method, params, key, (C, NB, 8)))
    _close(got_nll, want_nll)
    assert int(got_cc) == int(want_cc)


def _rank_one_down(kfn, lib):
    """The MLP kernel minus a rank-one term: an inducing Gram whose
    smallest eigenvalue is far below -r, the state fp32 round-off leaves
    a near-singular Gram in at design scale."""
    def kernel_fn(x1, x2=None, get="nngp"):
        x2 = x1 if x2 is None else x2
        return kfn(x1, x2, get=get) - 0.05 * lib.outer(x1.sum(-1), x2.sum(-1)) / x1.shape[-1]
    return kernel_fn


def test_the_chol_fn_branch_has_no_guard_in_either_package():
    """JAX's factorization branch lifts k_ii + eps I but not k_ii + r I
    (ROADMAP Queue 3): on an indefinite inducing Gram both packages' ELBOs
    are NaN there. Both eigh paths stay finite (their values, set by the
    eigenvalue floor, are not compared)."""
    key = random.PRNGKey(1)
    for route, finite in (("none", True), ("chol_fn", False)):
        kw = (lambda lib: {}) if route == "none" else CHOL["chol_fn"]
        jm, tm, params, x, y = _mlp_models("svgp", kw, kernel_wrap=_rank_one_down)
        k_ii = np.asarray(jm.kernel.K(jm.kernel.get_kernel_fn(params["kernel"]),
                                      params["inducing_variable"]))
        assert np.linalg.eigvalsh(k_ii.astype(np.float64))[0] < -0.5
        want = float(jm.loss(params, key, x, y, 100, S))
        with torch.no_grad():
            got = float(tm.loss(to_torch(x), torch.as_tensor(y), 100, S,
                                draws=_draws("svgp", params, key, (S, C, NB))))
        assert np.isfinite(want) == finite and np.isfinite(got) == finite


@pytest.mark.parametrize("method", ["svgp", "svtp"])
def test_fit_svsp_with_a_chol_fn_matches(method):
    jm, tm, params, x, y = _mlp_models(method, CHOL["chol_fn"])
    want = jfit_svsp(jm, params)
    with torch.no_grad():
        got = tfit_svsp(tm)
    for name in ("k_ii_inv", "k_rel_inv", "w"):
        ref = np.asarray(want.state[name])
        _close(got.state[name], ref, atol=1e-5 * np.abs(ref).max())
    key = random.PRNGKey(2)
    want_nll, want_cc = want.test_acc_nll(key, x, y, 8)
    with torch.no_grad():
        got_nll, got_cc = got.test_acc_nll(to_torch(x), torch.as_tensor(y), 8,
                                           draws=_draws(method, params, key, (C, NB, 8)))
    _close(got_nll, want_nll)
    assert int(got_cc) == int(want_cc)


# -- the batch-sharded ELBO --------------------------------------------------------------

P_SHARDS, EB, EI = 4, 8, 6          # 8 x 8 images: batch 8 on 4 shards, 6 inducing


def _conv_models(network, method, seed=21):
    rng = np.random.RandomState(seed)
    shape = (8, 8, 3)
    z = rng.rand(EI, *shape).astype(np.float32)
    x = rng.rand(EB, *shape).astype(np.float32)
    y = rng.randint(C, size=EB)
    if network == "cnn":
        def jk(w, b, l):
            return jarch.get_cnn_kernel(2, C, "relu", w_std=w, b_std=b, last_w_std=l)

        def tk(w, b, l):
            return tarch.get_cnn_kernel(2, C, "relu", w_std=w, b_std=b, last_w_std=l)
    elif network == "resnet":
        def jk(w, b, l):
            return jarch.get_conv_resnet_kernel(1, C, "relu", w_std=w, b_std=b, last_w_std=l)

        def tk(w, b, l):
            return tarch.get_conv_resnet_kernel(1, C, "relu", w_std=w, b_std=b, last_w_std=l)
    else:
        def jk(w, b, l):
            return jarch.get_myrtle_kernel(5, C, "relu", w_std=w, b_std=b, last_w_std=l,
                                           trainable_inputs=False)

        def tk(w, b, l):
            return tarch.get_myrtle_kernel(5, C, "relu", w_std=w, b_std=b, last_w_std=l,
                                           trainable_inputs=False)
    jp, tp = (JG(), TG()) if method == "svgp" else (JI(2.0, 2.0), TI(2.0, 2.0))
    jm = JSVSP(jp, JK(jk, 1.2, 0.1, 1.0), z, num_latent_gps=C, eps=1e-3)
    tm = TSVSP(tp, TK(tk, 1.2, 0.1, 1.0), z, num_latent_gps=C, eps=1e-3)
    params = _load(jm, tm, rng)
    return jm, tm, params, x, y


def _port_loss_and_grads(tm, x, y, draws, mesh):
    tm.zero_grad()
    loss = tm.loss(to_torch(x), torch.as_tensor(y), 100, S, draws=draws, mesh=mesh)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("network,method", [("cnn", "svgp"), ("cnn", "svtp"),
                                            ("resnet", "svgp"), ("myrtle", "svtp")])
def test_batch_sharded_elbo_matches(network, method, monkeypatch):
    jm, tm, params, x, y = _conv_models(network, method)
    key = random.PRNGKey(5)
    draws = _draws(method, params, key, (S, C, EB))
    mesh = get_mesh(P_SHARDS, device="cpu")
    from snngp_torch.parallel import gram as G
    panels = []
    sharded = G.sharded_gram

    def recording(kernel_fn, xb, *a, **kw):
        out = sharded(kernel_fn, xb, *a, **kw)
        panels.append([tuple(t.shape) for t in out])
        return out

    monkeypatch.setattr(G, "sharded_gram", recording)
    got, got_g = _port_loss_and_grads(tm, x, y, draws, mesh)
    # k_bi and k_bb as row panels, one a shard; k_ii on the lead device.
    assert panels == [[(EB // P_SHARDS, EI)] * P_SHARDS, [(EB // P_SHARDS, EB)] * P_SHARDS]
    one, one_g = _port_loss_and_grads(tm, x, y, draws, None)
    np.testing.assert_allclose(got, one, rtol=1e-6)
    scale = max(g.abs().max().item() for g in one_g.values())
    for name in got_g:
        _close(got_g[name], one_g[name].numpy(), rtol=1e-4, atol=1e-6 * scale)

    sharding = NamedSharding(jget_mesh(P_SHARDS), PartitionSpec("data"))
    xs, ys = jax.device_put(x, sharding), jax.device_put(y, sharding)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, xb, yb: jm.loss(p, key, xb, yb, 100, S)))(params, xs, ys)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    want_g = {n: np.asarray(g) for n, g in jnamed(want_g)}
    if network == "myrtle":
        del want_g["inducing_variable"]   # frozen: zero x cotangents here, masked in JAX
    scale = max(np.abs(g).max() for g in want_g.values())
    for name, wg in want_g.items():
        _close(got_g[name], wg, rtol=1e-4, atol=1e-6 * scale)


# -- myrtle_gram_sharded -----------------------------------------------------------------

HP = dict(w_std=1.0, b_std=0.1, last_w_std=1.0)


@pytest.mark.parametrize("layout", ["1-D", "1-D symmetric", "2x2 symmetric"])
def test_myrtle_gram_sharded_matches_the_jax_full_tier(layout):
    rng = np.random.RandomState(6)
    x1 = rng.rand(8, 8, 8, 3).astype(np.float32)
    x2 = None if "symmetric" in layout else rng.rand(12, 8, 8, 3).astype(np.float32)
    mesh = (get_mesh(shape=(2, 2), device="cpu") if layout.startswith("2x2")
            else get_mesh(4, device="cpu"))
    shards = myrtle_gram_sharded(to_torch(x1), None if x2 is None else to_torch(x2), mesh,
                                 depth=5, act="relu", **HP)
    if layout.startswith("2x2"):
        assert [[tuple(t.shape) for t in row] for row in shards] == [[(4, 4)] * 2] * 2
    else:
        assert [tuple(t.shape) for t in shards] == [(2, 8 if x2 is None else 12)] * 4
    want = np.asarray(jax.jit(jfull_myrtle(5, 1, "relu", **HP))(x1, x1 if x2 is None else x2))
    _close(gather(shards), want, rtol=2e-5, atol=1e-6)
