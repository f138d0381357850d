"""Port parity: snngp_torch/parallel (mesh, sharded Gram, blocked / in-place /
cyclic / distributed Cholesky, the panel triangular solve) against
snngp/parallel on the same numpy inputs. The JAX side runs on its 8-device
CPU mesh (tests/conftest.py); the port's meshes are 8, 4 and 2 x 2 shards
of the CPU.

Tolerances: float32 results within 1e-5 of the largest entry of the JAX
result (max |got - want| <= 1e-5 max |want|) on matrices of condition
number ~10 (a a^T / n + I), where two factorization orders differ by a few
ulp; float64 (``jax.enable_x64``) within 1e-12, round-off. The cyclic
factorization's d logdet / d scale: rtol 1e-5 against JAX's (the JAX
package's own bar, tests/test_parallel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snngp.nn import arch as jarch
from snngp.parallel import get_mesh as jget_mesh, sharded_gram as jsharded_gram
from snngp.parallel import cholesky as JC
from snngp.parallel.mesh import init_distributed as j_init_distributed

from snngp_torch.nn import arch as tarch
from snngp_torch.parallel import cholesky as TC
from snngp_torch.parallel import mesh as TM
from snngp_torch.parallel.gram import sharded_gram

from _torch_parity import to_numpy

F32 = 1e-5
F64 = 1e-12


def _psd(n, seed, jitter=1.0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n)
    return (a @ a.T / n + jitter * np.eye(n)).astype(dtype)


def _close(got, want, tol):
    got, want = to_numpy(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= tol, f"max error {err:.3e} of max |want| (tolerance {tol})"


def _cpu_mesh(n):
    return TM.get_mesh(n, device="cpu")


# -- blocked and in-place factorizations -------------------------------------------------

@pytest.mark.parametrize("n,block,panel_inverse", [(256, 64, False), (256, 64, True),
                                                   (200, 64, False), (200, 64, True),
                                                   (100, 64, False), (64, 64, False),
                                                   (700, None, False)])
def test_blocked_cholesky_matches_jax(n, block, panel_inverse):
    a = _psd(n, seed=n)
    want = JC.blocked_cholesky(jnp.asarray(a), block=block, panel_inverse=panel_inverse)
    got = TC.blocked_cholesky(torch.as_tensor(a), block=block, panel_inverse=panel_inverse)
    _close(got, want, F32)
    assert np.all(np.triu(to_numpy(got), 1) == 0)


@pytest.mark.parametrize("panel_inverse", [False, True])
def test_blocked_cholesky_float64_round_off(panel_inverse):
    a = _psd(130, seed=3, jitter=1e-2, dtype=np.float64)
    with jax.enable_x64(True):
        want = np.asarray(JC.blocked_cholesky(jnp.asarray(a), block=32,
                                              panel_inverse=panel_inverse))
    got = TC.blocked_cholesky(torch.as_tensor(a), block=32, panel_inverse=panel_inverse)
    _close(got, want, F64)


def test_blocked_cholesky_is_differentiable():
    # d logdet(s A) / ds = n / s through the panels, in float64
    a = torch.as_tensor(_psd(70, seed=4, dtype=np.float64))
    s = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    logdet = 2.0 * torch.log(torch.diagonal(TC.blocked_cholesky(s * a, block=16))).sum()
    (g,) = torch.autograd.grad(logdet, s)
    assert abs(g.item() - 70 / 1.3) <= 1e-12 * 70 / 1.3


@pytest.mark.parametrize("n", [1, 7, 64, 130, 257])
def test_inplace_blocked_cholesky_matches_jax(n):
    a = _psd(n, seed=10 + n)
    want = np.asarray(JC.inplace_blocked_cholesky(jnp.asarray(a), block=64))
    buf = torch.as_tensor(a.copy())
    ptr = buf.data_ptr()
    got = TC.inplace_blocked_cholesky(buf, block=64)
    assert got.data_ptr() == ptr and got is buf          # factored in its own buffer
    assert np.all(np.tril(to_numpy(got), -1) == 0)       # upper, strict lower zeroed
    _close(got, want, F32)
    _close(got.mT @ got, a, F32)


def test_inplace_blocked_cholesky_float64_and_failure():
    a = _psd(96, seed=5, jitter=1e-2, dtype=np.float64)
    with jax.enable_x64(True):
        want = np.asarray(JC.inplace_blocked_cholesky(jnp.asarray(a)))
    _close(TC.inplace_blocked_cholesky(torch.as_tensor(a.copy())), want, F64)
    bad = torch.as_tensor(-np.eye(8, dtype=np.float32))
    assert torch.isnan(torch.diagonal(TC.inplace_blocked_cholesky(bad))).any()
    with pytest.raises(ValueError, match="contiguous"):
        TC.inplace_blocked_cholesky(torch.as_tensor(a).mT)


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("rhs", [None, 3])
@pytest.mark.parametrize("block", [None, 24, 64])
def test_blocked_triangular_solve_matches_jax(trans, rhs, block):
    n = 150
    u = np.array(JC.inplace_blocked_cholesky(jnp.asarray(_psd(n, seed=6))))
    rng = np.random.RandomState(7)
    b = rng.randn(n).astype(np.float32) if rhs is None else rng.randn(n, rhs).astype(
        np.float32)
    want = JC.blocked_triangular_solve(jnp.asarray(u), jnp.asarray(b), trans=trans,
                                       block=block)
    got = TC.blocked_triangular_solve(torch.as_tensor(u), torch.as_tensor(b), trans=trans,
                                      block=block)
    assert got.shape == b.shape
    _close(got, want, F32)


def test_blocked_triangular_solve_float64_round_off():
    n = 120
    a = _psd(n, seed=8, jitter=1e-2, dtype=np.float64)
    u = torch.linalg.cholesky(torch.as_tensor(a)).mT.contiguous()
    b = torch.as_tensor(np.random.RandomState(9).randn(n, 2))
    x = TC.blocked_triangular_solve(u, TC.blocked_triangular_solve(u, b, trans=True),
                                    block=32)
    _close(x, np.linalg.solve(a, b.numpy()), 1e-10)    # cond(a) ~ 4e2: round-off


# -- mesh factorizations -----------------------------------------------------------------

@pytest.mark.parametrize("n0,block,shards", [(96, 16, 8), (130, 16, 8), (200, 32, 8),
                                             (64, 8, 4), (257, 32, 2)])
def test_cyclic_cholesky_matches_jax(n0, block, shards):
    """Sizes that are not a multiple of block x shards (JAX pads them with an
    identity; the port's last block is ragged)."""
    a = _psd(n0, seed=n0)
    mesh = jget_mesh(shards)
    want = jax.jit(lambda m: JC.cyclic_cholesky(m, mesh, block=block))(jnp.asarray(a))
    got = TC.cyclic_cholesky(torch.as_tensor(a), _cpu_mesh(shards), block=block)
    assert got.shape == (n0, n0)
    _close(got, want, F32)


def test_cyclic_cholesky_gradients_match_jax():
    """d logdet(s A) / ds through the cyclic factorization (autograd through
    the panel broadcasts and the out-of-place updates) against JAX's, and in
    float64 against the exact n / s (JAX's cyclic factorization does not
    trace with 64-bit indices)."""
    base = _psd(128, seed=9, jitter=1e-2)
    mesh = jget_mesh(8)

    def ld(s):
        return 2.0 * jnp.sum(jnp.log(jnp.diagonal(
            JC.cyclic_cholesky(s * jnp.asarray(base), mesh, block=16))))

    want = float(jax.jit(jax.grad(ld))(jnp.asarray(1.3, jnp.float32)))
    for dtype, ref, rtol in ((torch.float32, want, 1e-5), (torch.float64, 128 / 1.3, F64)):
        s = torch.tensor(1.3, dtype=dtype, requires_grad=True)
        lfac = TC.cyclic_cholesky(s * torch.as_tensor(base, dtype=dtype), _cpu_mesh(8),
                                  block=16)
        (got,) = torch.autograd.grad(2.0 * torch.log(torch.diagonal(lfac)).sum(), s)
        np.testing.assert_allclose(got.item(), ref, rtol=rtol)


@pytest.mark.parametrize("strategy", ["pjit", "cyclic"])
@pytest.mark.parametrize("n", [200, 256])
def test_distributed_cholesky_matches_jax(strategy, n):
    a = _psd(n, seed=11)
    mesh = jget_mesh(8)
    want = jax.jit(lambda m: JC.distributed_cholesky(m, mesh, block=32, strategy=strategy))(
        jnp.asarray(a))
    got = TC.distributed_cholesky(torch.as_tensor(a), _cpu_mesh(8), block=32,
                                  strategy=strategy)
    _close(got, want, F32)


def test_distributed_cholesky_float64_and_single_device():
    a = torch.as_tensor(_psd(100, seed=12, jitter=1e-2, dtype=np.float64))
    want = torch.linalg.cholesky(a)
    for mesh in (_cpu_mesh(3), _cpu_mesh(1), None):
        for strategy in ("pjit", "cyclic"):
            _close(TC.distributed_cholesky(a, mesh, block=16, strategy=strategy), want, F64)
    with pytest.raises(ValueError, match="strategy"):
        TC.distributed_cholesky(a, _cpu_mesh(2), strategy="gspmd")


# -- sharded Gram ------------------------------------------------------------------------

def _jsharded(kfn, x, mesh, x2=None):
    return jax.jit(lambda a, b: jsharded_gram(kfn, a, mesh, x2=b))(jnp.asarray(x), x2)


def _kernels(depth, act, w, b, last):
    return (jarch.get_mlp_kernel(depth, 1, act, w_std=w, b_std=b, last_w_std=last),
            tarch.get_mlp_kernel(depth, 1, act, w_std=w, b_std=b, last_w_std=last))


@pytest.mark.parametrize("shards", [8, 4])
def test_sharded_gram_matches_jax(shards):
    x = np.random.RandomState(13).randn(64, 5).astype(np.float32)
    jk, tk = _kernels(2, "relu", 1.2, 0.2, 1.0)
    want = _jsharded(jk, x, jget_mesh(shards))
    panels = sharded_gram(tk, torch.as_tensor(x), _cpu_mesh(shards))
    assert len(panels) == shards and panels[0].shape == (64 // shards, 64)
    _close(TM.gather(panels), want, F32)


def test_sharded_gram_cross_matches_jax():
    rng = np.random.RandomState(14)
    x, x2 = rng.randn(32, 5).astype(np.float32), rng.randn(12, 5).astype(np.float32)
    jk, tk = _kernels(1, "erf", 1.0, 0.1, 1.0)
    want = _jsharded(jk, x, jget_mesh(4), x2=jnp.asarray(x2))
    got = TM.gather(sharded_gram(tk, torch.as_tensor(x), _cpu_mesh(4), x2=torch.as_tensor(x2)))
    _close(got, want, F32)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_sharded_gram_2d_mesh_matches_jax(shape):
    rng = np.random.RandomState(15)
    x, x2 = rng.randn(32, 5).astype(np.float32), rng.randn(16, 5).astype(np.float32)
    jk, tk = _kernels(2, "relu", 1.2, 0.2, 1.0)
    jmesh, tmesh = jget_mesh(shape=shape), TM.get_mesh(shape=shape, device="cpu")
    assert tmesh.axis_names == jmesh.axis_names == ("rows", "cols")
    assert tmesh.devices.shape == jmesh.devices.shape == shape
    tiles = sharded_gram(tk, torch.as_tensor(x), tmesh)
    assert len(tiles) == shape[0] and len(tiles[0]) == shape[1]
    _close(TM.gather(tiles), _jsharded(jk, x, jmesh), F32)
    _close(TM.gather(sharded_gram(tk, torch.as_tensor(x), tmesh, x2=torch.as_tensor(x2))),
           _jsharded(jk, x, jmesh, x2=jnp.asarray(x2)), F32)


def test_sharded_gram_diagonal_tiles_are_symmetric_launches(monkeypatch):
    # On a square 2-D mesh a diagonal tile passes one block as both operands
    seen = []
    _, tk = _kernels(1, "relu", 1.0, 0.1, 1.0)

    def spy(x1, x2, get="nngp"):
        seen.append(x1 is x2)
        return tk(x1, x2, get=get)

    x = torch.as_tensor(np.random.RandomState(16).randn(8, 3).astype(np.float32))
    sharded_gram(spy, x, TM.get_mesh(shape=(2, 2), device="cpu"))
    assert seen == [True, False, False, True]
    with pytest.raises(ValueError, match="divisible"):
        sharded_gram(tk, x[:7], _cpu_mesh(2))


# -- the mesh itself ---------------------------------------------------------------------

def test_get_mesh_and_shardings():
    mesh = _cpu_mesh(4)
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 4} and mesh.size == 4
    assert all(d == torch.device("cpu") for d in mesh.device_list())
    same = TM.get_mesh(devices=["cpu"] * 3)
    assert same.size == 3 and TM.get_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        TM.get_mesh(2, devices=["cpu"] * 3)
    x = torch.arange(24.0).reshape(8, 3)
    shards = list(x.chunk(4))
    assert torch.equal(TM.gather(shards), x)
    tiles = [list(p.chunk(3, dim=1)) for p in x.chunk(2)]
    assert torch.equal(TM.gather(tiles), x)
    assert all(s is x for s in TM.broadcast(x, mesh.device_list()))
    assert torch.equal(TM.reduce_sum(shards, "cpu"), sum(x.chunk(4)))


def test_get_mesh_on_cuda_needs_the_cards():
    """Too few cards is an error, never a smaller mesh (JAX returns one)."""
    have = TM.device_count("cuda")
    with pytest.raises(ValueError, match="cards"):
        TM.get_mesh(have + 1)
    assert TM.device_count("cpu") == 1


def _joined_mesh(join):
    """A one-rank gloo group joined by ``join()``: True, idempotent, and a mesh
    that spans it; left again before returning."""
    import torch.distributed as dist
    try:
        assert join() is True and TM.init_distributed() is True
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert TM.device_count() == TM.device_count("cpu") == 1
        mesh = TM.get_mesh(device="cpu")
        assert mesh.distributed and mesh.size == 1 and mesh.ranks.tolist() == [0]
        assert not TM.get_mesh(devices=["cpu"] * 2).distributed
        x = torch.arange(12.0).reshape(4, 3)
        assert torch.equal(TM.gather(sharded_gram(lambda a, b, get: a @ b.T, x, mesh)),
                           x @ x.T)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed(tmp_path):
    """No coordinator: the single-process no-op in both packages; a
    coordinator given as arguments: a one-rank gloo join."""
    assert TM.init_distributed() is False and j_init_distributed() is False
    _joined_mesh(lambda: TM.init_distributed(f"file://{tmp_path / 'rendezvous'}",
                                             num_processes=1, process_id=0, backend="gloo"))
    assert TM.init_distributed() is False


@pytest.mark.parametrize("names", [("COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK"),
                                   ("JAX_COORDINATOR_ADDRESS",),
                                   ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")])
def test_init_distributed_reads_the_environment(monkeypatch, names):
    """JAX's coordinator names (the world size and rank as arguments or from
    WORLD_SIZE / RANK), and torchrun's MASTER_ADDR / MASTER_PORT."""
    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "MEGASCALE_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
              "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    port = _free_port()
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "1",
           "RANK": "0"}
    for k in names:
        monkeypatch.setenv(k, env.get(k, f"localhost:{port}"))
    args = {} if "RANK" in names else dict(num_processes=1, process_id=0)
    _joined_mesh(lambda: TM.init_distributed(backend="gloo", **args))
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"localhost:{port}")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        TM.init_distributed()
