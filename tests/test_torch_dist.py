"""Port parity of the mesh across processes: ``init_distributed`` joins a
gloo process group of 2 and of 4 ranks on the CPU (spawned with
``torch.multiprocessing``, a ``file://`` rendezvous in a temporary
directory), and each rank runs the sharded Gram (1-D and 2 x 2), the
cyclic and the row-panel ("pjit") factorizations, the distributed ML-II
step, ``SPR.loss`` and its gradients, a CNN ``SVSP.loss(mesh=)`` gradient,
three ML-II optimizer steps, ``myrtle_gram_sharded`` and
``examples/mesh_pipeline.py`` on a mesh of one shard a rank
(``tests/_torch_dist_worker.py``, which imports no JAX).

Each result is held against the JAX package on its P-device CPU mesh
(tests/conftest.py) and against the port's mesh of one process with P
shards, which rank 0 runs in the same process:

- against JAX, tests/test_torch_parallel.py's bars: float32 within 1e-5 of
  max |want|, float64 within 1e-12; the ML-II step as
  tests/test_torch_mesh.py holds it (loss rtol 1e-5, gradients rtol 2e-4,
  atol 1e-7); the ELBO as tests/test_torch_mesh_cls.py does (loss rtol
  1e-5, gradients rtol 1e-4 with an atol of 1e-6 of the largest entry);
  the Myrtle Gram against the full tier, rtol 2e-5 / atol 1e-6;
- against the one-process mesh: the Grams and the factors bit for bit (the
  same launches on the same rows); q and logdet S of the ML-II step bit for
  bit and its six float64 sums within 1e-12 relative (an all-reduce sums
  in another order); losses bit for bit (every rank computes them from the
  same gathered Gram); gradients and parameters after three steps within
  1e-6 relative (the ranks' shares are added in another order);
- across the ranks: every loss, gradient and parameter bit for bit.

Each group gets 120 s to finish, and its ranks are killed when it does not.
"""

import pickle
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_dist_worker as W  # noqa: E402

from snngp.models import SPR as JSPR, GaussianLikelihood as JGauss  # noqa: E402
from snngp.models import NNGPKernel as JK, StudentTLikelihood as JStudent  # noqa: E402
from snngp.models import SVSP as JSVSP, GaussianPrior as JG  # noqa: E402
from snngp.models.params import named_leaves as jnamed  # noqa: E402
from snngp.nn import arch as jarch  # noqa: E402
from snngp.nn.full import get_myrtle_kernel as jfull_myrtle  # noqa: E402
from snngp.ops.pallas.gram import _reference_recursion as j_recursion  # noqa: E402
from snngp.parallel import get_mesh as jget_mesh, sharded_gram as jsharded_gram  # noqa: E402
from snngp.parallel import cholesky as JC  # noqa: E402
from snngp.parallel.mlii import distributed_mlii_value_and_grad as jdist_mlii  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from snngp_torch.models.params import from_jax_named  # noqa: E402

F32 = 1e-5
F64 = 1e-12
JOIN_S = 120.0


# -- the group ---------------------------------------------------------------------------

def _elbo_inputs():
    """The CNN ELBO's JAX model and parameters (random q_mu / q_sqrt), the
    port's state dict of them, and JAX's standard-normal draws."""
    z, _, _, rng = W.cnn_data()
    jm = JSVSP(JG(), JK(lambda w, b, l: jarch.get_cnn_kernel(2, W.C, "relu", w_std=w,
                                                             b_std=b, last_w_std=l),
                        1.2, 0.1, 1.0), z, num_latent_gps=W.C, eps=1e-3)
    params = jm.init_params()
    params["q_mu"] = jnp.asarray(0.3 * rng.randn(W.C, W.EI).astype(np.float32))
    params["q_sqrt"] = params["q_sqrt"] + jnp.asarray(
        0.2 * rng.randn(W.C, W.EI).astype(np.float32))
    key = random.PRNGKey(5)
    draws = np.asarray(random.normal(key, (W.S, W.C, W.EB)))
    return jm, params, key, from_jax_named(jax.tree.map(np.asarray, params)), draws


def _spawn(world, tmp, state, draws):
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.run, args=(r, world, str(tmp / "rendezvous"), str(tmp),
                                             state, draws)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        while any(p.is_alive() for p in procs):
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad:
                raise AssertionError(f"a rank of {world} exited with {bad}")
            if time.monotonic() > deadline:
                raise AssertionError(f"the {world} ranks did not finish in {JOIN_S:.0f} s")
            time.sleep(0.05)
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"the ranks exited with {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)]


@pytest.fixture(scope="module")
def elbo_inputs():
    return _elbo_inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def group(request, tmp_path_factory, elbo_inputs):
    world = request.param
    _, _, _, state, draws = elbo_inputs
    ranks = _spawn(world, tmp_path_factory.mktemp(f"ranks{world}"), state, draws)
    return world, ranks


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= tol, f"max error {err:.3e} of max |want| (tolerance {tol})"


def _same_on_every_rank(ranks, get):
    first = get(ranks[0])
    for r in ranks[1:]:
        _bitwise(get(r), first)
    return first


def _bitwise(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _bitwise(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bitwise(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -- the runtime -------------------------------------------------------------------------

def test_the_ranks_join_and_the_mesh_spans_them(group):
    world, ranks = group
    for r, out in enumerate(ranks):
        info = out["info"]
        assert info["device_count"] == info["device_count_cpu"] == world
        assert info["mesh"] == (world, list(range(world)), True, r)
        assert not info["jax"] and not info["jax_after"], "a rank imported jax"
        local = out["got"]["gram"]["local"]
        assert local == [r], f"rank {r} ran shards {local}"


# -- the sharded Gram --------------------------------------------------------------------

def _jsharded(x, mesh):
    kfn = jarch.get_mlp_kernel(2, 1, "relu", w_std=1.2, b_std=0.2, last_w_std=1.0)
    return np.asarray(jax.jit(lambda a: jsharded_gram(kfn, a, mesh))(jnp.asarray(x)))


@pytest.mark.parametrize("layout", ["1-D", "2x2"])
def test_sharded_gram_matches_jax_and_one_process(group, layout):
    world, ranks = group
    got = _same_on_every_rank(ranks, lambda o: o["got"]["gram"][layout])
    x = W.gram_data()
    jmesh = jget_mesh(world) if layout == "1-D" else jget_mesh(shape=(2, 2))
    _close(got, _jsharded(x, jmesh), F32)
    _bitwise(got, ranks[0]["ref"]["gram"][layout])


# -- the factorizations ------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["cyclic", "pjit"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_distributed_factorizations_match_jax_and_one_process(group, strategy, dtype):
    world, ranks = group
    got = _same_on_every_rank(ranks, lambda o: o["got"]["cholesky"][f"{strategy} {dtype}"])
    _bitwise(got, ranks[0]["ref"]["cholesky"][f"{strategy} {dtype}"])
    a = W.psd(64, seed=7, dtype=np.float64 if dtype == "float64" else np.float32)
    mesh = jget_mesh(world)
    if dtype == "float64":
        want = np.linalg.cholesky(a)      # JAX's cyclic factorization does not trace in x64
        _close(got, want, F64)
        return
    want = jax.jit(lambda m: JC.distributed_cholesky(m, mesh, block=8, strategy=strategy))(
        jnp.asarray(a))
    _close(got, np.asarray(want), F32)
    if strategy == "cyclic":            # one broadcast a block column, on every rank
        for out in ranks:
            assert out["got"]["cholesky"][f"cyclic broadcasts {dtype}"] == 64 // 8


# -- the distributed ML-II step ----------------------------------------------------------

def _jax_aug():
    w, b, l = (jnp.asarray(W.HYPER[k], jnp.float32) for k in ("w_std", "b_std", "last_w_std"))

    def aug(x1, x2):
        f = lambda wv, bv: j_recursion(x1, x2, 3, "relu", wv, bv, l)  # noqa: E731
        _, dkw = jax.jvp(lambda wv: f(wv, b), (w,), (jnp.ones_like(w),))
        _, dkb = jax.jvp(lambda bv: f(w, bv), (b,), (jnp.ones_like(b),))
        return f(w, b), dkw, dkb

    return aug


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_distributed_mlii_matches_jax_and_one_process(group, method):
    world, ranks = group
    loss, grads = _same_on_every_rank(ranks, lambda o: o["got"]["mlii"][method])
    ab = None if method == "gp" else (2.0, 1.5)
    x, y = W.mlii_data()
    mesh = jget_mesh(world)
    want_loss, want_g = jax.jit(lambda xx, yy: jdist_mlii(
        _jax_aug(), xx, yy, mesh, last_w_std=W.HYPER["last_w_std"], eps=W.MLII_EPS, ab=ab,
        chol_block=4))(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(loss, float(want_loss), rtol=F32)
    assert sorted(grads) == sorted(want_g)
    for name in grads:
        np.testing.assert_allclose(grads[name], float(want_g[name]), rtol=2e-4, atol=1e-7,
                                   err_msg=name)
    q, logdet, sums = _same_on_every_rank(ranks, lambda o: o["got"]["mlii"]["scalars"])
    q1, logdet1, sums1 = ranks[0]["ref"]["mlii"]["scalars"]
    assert (q, logdet) == (q1, logdet1)
    np.testing.assert_allclose(sums, sums1, rtol=F64, atol=0)
    ref_loss, ref_g = ranks[0]["ref"]["mlii"][method]
    np.testing.assert_allclose(loss, ref_loss, rtol=F64)
    for name in grads:
        np.testing.assert_allclose(grads[name], ref_g[name], rtol=1e-9, atol=1e-12)


# -- autograd across ranks ---------------------------------------------------------------

def _jax_spr(method):
    x, y = W.spr_data()
    kernel = JK(lambda w, b, l: jarch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b,
                                                     last_w_std=l), 1.2, 0.5, 0.9)
    lik = JGauss() if method == "gp" else JStudent(1.5, 2.5)
    return JSPR(kernel, lik, x, y, jnp.array(0.7), jnp.array(1.3), eps=W.LOSS_EPS,
                mesh=jget_mesh(8), chol_block=8)


def _check_grads(got, want, one, rtol, atol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)
        np.testing.assert_allclose(got[name], one[name], rtol=1e-6,
                                   atol=1e-6 * np.abs(one[name]).max(), err_msg=name)


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_spr_loss_gradients_match_jax_and_one_process(group, method):
    world, ranks = group
    loss, grads = _same_on_every_rank(ranks, lambda o: o["got"]["spr"][method])
    one_loss, one = ranks[0]["ref"]["spr"][method]
    assert loss == one_loss
    jm = _jax_spr(method)
    want_loss, want_g = jax.jit(jax.value_and_grad(jm.loss))(jm.init_params())
    np.testing.assert_allclose(loss, float(want_loss), rtol=F32)
    want = {n: float(g) for n, g in jnamed(want_g)}
    _check_grads({n: float(g) for n, g in grads.items()}, want, one, F32,
                 F32 * max(abs(v) for v in want.values()))


def test_cnn_elbo_gradient_matches_jax_and_one_process(group, elbo_inputs):
    world, ranks = group
    loss, grads = _same_on_every_rank(ranks, lambda o: o["got"]["elbo"])
    one_loss, one = ranks[0]["ref"]["elbo"]
    assert loss == one_loss
    jm, params, key, _, _ = elbo_inputs
    _, x, y, _ = W.cnn_data()
    sharding = NamedSharding(jget_mesh(world), PartitionSpec("data"))
    xs, ys = jax.device_put(x, sharding), jax.device_put(y, sharding)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, xb, yb: jm.loss(p, key, xb, yb, 100, W.S)))(params, xs, ys)
    np.testing.assert_allclose(loss, float(want), rtol=F32)
    want_g = {n: np.asarray(g) for n, g in jnamed(want_g)}
    scale = max(np.abs(g).max() for g in want_g.values())
    assert "inducing_variable" in grads      # z's gradient crossed the ranks too
    _check_grads(grads, want_g, one, 1e-4, 1e-6 * scale)


def test_three_steps_keep_the_ranks_identical(group):
    world, ranks = group
    losses, params = _same_on_every_rank(ranks, lambda o: o["got"]["steps"])
    one_losses, one_params = ranks[0]["ref"]["steps"]
    np.testing.assert_allclose(losses, one_losses, rtol=1e-6)
    assert losses[-1] < losses[0]
    for name in params:
        np.testing.assert_allclose(params[name], one_params[name], rtol=1e-6, err_msg=name)


# -- myrtle_gram_sharded -----------------------------------------------------------------

def test_myrtle_gram_sharded_matches_the_jax_full_tier(group):
    world, ranks = group
    got = _same_on_every_rank(ranks, lambda o: o["got"]["myrtle"])
    _bitwise(got, ranks[0]["ref"]["myrtle"])
    x = W.myrtle_data()
    want = np.asarray(jax.jit(jfull_myrtle(5, 1, "relu", w_std=1.0, b_std=0.1,
                                           last_w_std=1.0))(x, x))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


# -- examples/mesh_pipeline.py -----------------------------------------------------------

def test_mesh_pipeline_runs_across_the_ranks(group):
    """The example joins nothing more (the group is up), spans the ranks,
    prints on rank 0 only, checks parity there and gets the one-process
    mesh's NLL on every rank, bit for bit."""
    world, ranks = group
    nll, parity, said = ranks[0]["got"]["pipeline"]
    assert f"ranks {list(range(world))}" in said and "parity vs single device: OK" in said
    assert parity is not None
    for out in ranks[1:]:
        got, got_parity, got_said = out["got"]["pipeline"]
        assert got == nll and got_parity is None and got_said == ""
    assert nll == ranks[0]["ref"]["pipeline"][0]
