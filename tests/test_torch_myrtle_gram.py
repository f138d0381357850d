"""Port parity: the fused Myrtle Gram (``snngp_torch.ops.myrtle_gram``, K7's
plain version on the CPU) against the JAX package: its full tier, its
Pallas kernel in interpret mode, its scale tangents and its VJPs.

Tolerances:
- K against the JAX full tier and the interpret-mode kernel: fp32 rtol
  2e-5 / atol 1e-6, the bar of tests/test_myrtle_pallas.py (the slab
  order sums the stencils and pools in another order than either);
- (K, dK/dw, dK/db) of ``myrtle_gram_scale_grads`` against the JAX
  function: rtol 1e-6 / atol 1e-7, its own split test's bar;
- the VJPs against ``jax.grad`` through the JAX full tier: rtol 1e-5 (the
  scalar VJP's sums are float64 here, fp32 reverse-mode there);
- profiles and their tangents: rtol 1e-6 / atol 1e-7;
- K7's bf16 plain version and the JAX bf16 kernel in interpret mode: each
  against the float64 plain version under the fixed ceilings of BF16_REACH
  (``assert_fp32_reach``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snngp.ops.pallas.myrtle_gram as mg
import snngp_torch.ops.myrtle_gram as MG
from snngp.nn.full import get_myrtle_kernel as jax_full

from _torch_parity import assert_fp32_reach, cuda_device, to_numpy  # noqa: F401  (fixture)

HP = dict(w_std=1.3, b_std=0.2, last_w_std=1.1)


def _data(n1, n2, h, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n1, h, h, 3).astype(np.float32),
            rng.rand(n2, h, h, 3).astype(np.float32))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("depth,act,h", [(5, "relu", 8), (7, "relu", 8), (10, "relu", 8),
                                         (5, "erf", 8), (7, "erf", 8), (10, "erf", 8),
                                         (5, "relu", 16)])
def test_plain_matches_jax_full_tier(depth, act, h):
    x1, x2 = _data(3, 5, h, seed=depth)
    want = np.asarray(jax.jit(jax_full(depth, 1, act, **HP))(x1, x2))
    got = to_numpy(MG.myrtle_gram(*_t(x1, x2), depth=depth, act=act, **HP))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_symmetric_default_and_chunked_plain(monkeypatch):
    x1, _ = _data(5, 1, 8, seed=3)
    want = np.asarray(jax.jit(jax_full(5, 1, "relu", **HP))(x1, x1))
    got = to_numpy(MG.myrtle_gram(torch.as_tensor(x1), depth=5, act="relu", **HP))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    # Chunks of one x1 row give the same bits as one chunk.
    monkeypatch.setitem(MG._PLAIN_BYTES, "cpu", 1)
    again = to_numpy(MG.myrtle_gram(torch.as_tensor(x1), depth=5, act="relu", **HP))
    np.testing.assert_array_equal(again, got)


def test_plain_matches_jax_pallas_interpret(monkeypatch):
    monkeypatch.setattr(mg, "INTERPRET", True)
    x1, x2 = _data(4, 8, 8, seed=1)
    want = np.asarray(mg.myrtle_gram(x1, x2, depth=5, act="relu", **HP))
    got = to_numpy(MG.myrtle_gram(*_t(x1, x2), depth=5, act="relu", **HP))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


SG = dict(depth=5, act="relu", w_std=1.2, b_std=0.25, last_w_std=0.9)


@pytest.fixture(scope="module")
def jax_scale_grads():
    mg.INTERPRET = True
    try:
        x1, x2 = _data(4, 8, 8, seed=13)
        return x1, x2, [np.asarray(a) for a in mg.myrtle_gram_scale_grads(
            x1, x2, split=False, **SG)]
    finally:
        mg.INTERPRET = False


@pytest.mark.parametrize("split", [None, False, True])
@pytest.mark.parametrize("with_profiles", [False, True])
def test_scale_grads_match_jax(jax_scale_grads, split, with_profiles):
    x1, x2, want = jax_scale_grads
    t1, t2 = _t(x1, x2)
    profiles = None
    if with_profiles:
        kw = dict(depth=5, act="relu", w_std=1.2, b_std=0.25)
        profiles = (MG.myrtle_profile_tangents(t1, **kw), MG.myrtle_profile_tangents(t2, **kw))
    got = MG.myrtle_gram_scale_grads(t1, t2, split=split, profiles=profiles, **SG)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("depth,act", [(5, "relu"), (7, "erf")])
def test_scalar_vjp_matches_jax_grad(depth, act):
    """trainable_inputs=False: the tangent mode's scale cotangents, zero x
    cotangents, against reverse mode through the JAX full tier."""
    x1, x2 = _data(4, 6, 8, seed=9)
    g = np.random.RandomState(1).rand(4, 6).astype(np.float32)

    def loss_ref(w, b, l):
        return jnp.sum(g * jax_full(depth, 1, act, w_std=w, b_std=b, last_w_std=l)(x1, x2))

    want = jax.jit(jax.grad(loss_ref, argnums=(0, 1, 2)))(1.3, 0.2, 1.1)
    leaves = [torch.tensor(v, requires_grad=True) for v in (x1, x2, 1.3, 0.2, 1.1)]
    k = MG.myrtle_gram(leaves[0], leaves[1], depth=depth, act=act, w_std=leaves[2],
                       b_std=leaves[3], last_w_std=leaves[4], trainable_inputs=False)
    got = torch.autograd.grad(torch.sum(torch.as_tensor(g) * k), leaves)
    assert not got[0].any() and not got[1].any()
    for a, b in zip(got[2:], want):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5)


def test_trainable_inputs_vjp_matches_jax_grad():
    """trainable_inputs=True: x and scale cotangents by autograd through the
    port's full tier."""
    x1, x2 = _data(2, 3, 8, seed=2)
    g = np.random.RandomState(2).rand(2, 3).astype(np.float32)

    def loss_ref(a, c, w, b, l):
        return jnp.sum(g * jax_full(5, 1, "relu", w_std=w, b_std=b, last_w_std=l)(a, c))

    want = jax.jit(jax.grad(loss_ref, argnums=(0, 1, 2, 3, 4)))(x1, x2, 1.2, 0.3, 1.0)
    leaves = [torch.tensor(v, requires_grad=True) for v in (x1, x2, 1.2, 0.3, 1.0)]
    k = MG.myrtle_gram(leaves[0], leaves[1], depth=5, act="relu", w_std=leaves[2],
                       b_std=leaves[3], last_w_std=leaves[4])
    got = torch.autograd.grad(torch.sum(torch.as_tensor(g) * k), leaves)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want[:2])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5, atol=1e-5 * scale)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5)


def test_profiles_and_tangents_match_jax_and_are_finite_at_c_one():
    """The per-sample covariance meets c = 1 on its spatial diagonal, where
    autograd through acos gives NaN; the analytic JVP keeps it finite."""
    x, _ = _data(3, 1, 8, seed=4)
    want_p, want_t = mg._profiles_with_tangents(jnp.asarray(x), (1, 1, 1), "relu", 1.2, 0.3)
    got_p, got_t = MG.myrtle_profile_tangents(torch.as_tensor(x), depth=5, act="relu",
                                              w_std=1.2, b_std=0.3)
    assert [tuple(p.shape) for p in got_p] == [(3, 8, 8), (3, 4, 4), (3, 2, 2)]
    for g, w in zip(got_p + got_t, list(want_p) + list(want_t)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=1e-6, atol=1e-7)
    chunked = MG.myrtle_var_profiles(torch.as_tensor(x), (1, 1, 1), "relu", 1.2, 0.3,
                                     chunk=2)
    for a, b in zip(chunked, got_p):
        np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
    from snngp_torch.nn.layers import _relu_t
    k = torch.tensor([1.0, -1.0, 0.3], dtype=torch.float64)
    v = torch.ones(3, dtype=torch.float64)
    _, tangent = torch.func.jvp(lambda s: _relu_t(s * k, s * v, s * v),
                                (torch.tensor(1.0, dtype=torch.float64),),
                                (torch.tensor(1.0, dtype=torch.float64),))
    assert torch.isfinite(tangent).all()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tiled_resume_across_packages(writer, tmp_path, monkeypatch):
    """A resume file (the Gram memmap and its block bitmap) written by one
    package, with half its blocks lost, is finished by the other. The JAX
    side's fused call is its full tier: the bookkeeping is under test."""
    def jax_block(depth, act, dtype_key):
        return jax.jit(lambda a, b, w, bs, l: jax_full(depth, 1, act, w_std=w, b_std=bs,
                                                       last_w_std=l)(a, b))

    monkeypatch.setattr(mg, "_tiled_jit", jax_block)
    x, _ = _data(10, 1, 8, seed=6)
    path = str(tmp_path / "gram.npy")

    def run_jax(**kw):
        return np.asarray(mg.myrtle_gram_tiled(jnp.asarray(x), block=4, **kw, **HP))

    def run_torch(**kw):
        return MG.myrtle_gram_tiled(torch.as_tensor(x), block=4, **kw, **HP)

    first, second = (run_jax, run_torch) if writer == "jax" else (run_torch, run_jax)
    want = run_torch()
    first(resume_path=path)
    done = np.load(path + ".done.npy")
    assert done.shape == (6,) and done.all()
    # Blocks (0, 4), (4, 4) and (8, 8) of the upper triangle are lost.
    done[1::2] = False
    np.save(path + ".done.npy", done)
    gram = np.lib.format.open_memmap(path, mode="r+")
    gram[0:8, 4:8] = np.nan
    gram[4:8, 0:4] = np.nan
    gram[8:, 8:] = np.nan
    gram.flush()
    del gram
    got = second(resume_path=path)
    assert np.load(path + ".done.npy").all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    with pytest.raises(ValueError, match="block"):
        MG.myrtle_gram_tiled(torch.as_tensor(x[:8]), block=4, resume_path=path, **HP)


def test_tiled_cross_blocks_and_logging():
    x1, x2 = _data(6, 5, 8, seed=7)
    lines = []
    got = MG.myrtle_gram_tiled(*_t(x1, x2), block=4, log=lines.append, **HP)
    want = to_numpy(MG.myrtle_gram(*_t(x1, x2), **HP))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert lines and "block 4/4" in lines[-1]


def test_arch_dispatch(monkeypatch):
    """Square power-of-two images from 8 x 8 to 32 x 32 go to the fused
    Gram; other shapes and get="ntk" to the full tier."""
    from snngp_torch.nn import arch
    calls = []
    real = MG.myrtle_gram

    def spy(x1, x2, **kw):
        calls.append(tuple(x1.shape[1:3]))
        return real(x1, x2, **kw)

    monkeypatch.setattr(MG, "myrtle_gram", spy)
    kfn = arch.get_myrtle_kernel(5, 1, "relu", **HP)
    assert arch.KERNELS["myrtle"] is arch.get_myrtle_kernel
    x8, y8 = _data(2, 3, 8)
    k8 = kfn(torch.as_tensor(x8))
    assert calls == [(8, 8)] and k8.shape == (2, 2)
    # Off the diagonal: the arccos derivative at c = 1 amplifies round-off.
    ntk = kfn(*_t(x8, y8), get="ntk")
    want = jax.jit(lambda a, b: jax_full(5, 1, "relu", **HP)(a, b, get="ntk"))(x8, y8)
    np.testing.assert_allclose(to_numpy(ntk), np.asarray(want), rtol=2e-5, atol=1e-6)
    x24 = np.random.RandomState(8).rand(1, 24, 24, 1).astype(np.float32)
    kfn(torch.as_tensor(x24))
    assert calls == [(8, 8)]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, _ = _data(2, 1, 8)
    t = torch.as_tensor(x)
    with pytest.raises(ValueError, match="power-of-two"):
        MG.myrtle_gram(torch.zeros(2, 12, 12, 3))
    # A bf16 pair state is forward-only, as in the JAX package.
    with pytest.raises(ValueError, match="fp32-only"):
        MG.myrtle_gram(t, dtype=torch.bfloat16, trainable_inputs=False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        MG.myrtle_gram(t, dtype=torch.float16)
    with pytest.raises(ValueError, match="Myrtle depth"):
        MG.myrtle_gram(t, depth=6)
    p = MG.pack_profiles(MG.myrtle_var_profiles(t, (1, 1, 1), "relu", 1.0, 0.1))
    scales = torch.tensor([1.0, 0.01, 1.0, 1 / 3])
    with pytest.raises(ValueError, match="CUDA"):
        MG.myrtle_gram_cuda(t, t, p, p, scales, depth=5, act="relu")
    # One slab column a lane: both modes take h <= 32.
    x64 = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="h <= 32"):
        MG.myrtle_gram_cuda(x64, x64, p, p, scales, depth=5, act="relu")
    with pytest.raises(ValueError, match="same=True"):
        MG.myrtle_gram_cuda(t, t[:1], p, p[:1], scales, depth=5, act="relu", same=True)
    d = MG.pack_profiles(MG.myrtle_profile_tangents(t, depth=5)[1])
    scales6 = torch.tensor([1.0, 0.01, 1.0, 1 / 3, 1.0, 0.1])
    with pytest.raises(ValueError, match="same=True"):
        MG.myrtle_gram_tangents_cuda(t, t[:1], p, p[:1], d, d[:1], scales6, depth=5,
                                     act="relu", same=True)
    with pytest.raises(ValueError, match="CUDA"):
        MG.myrtle_gram_tangents_cuda(t, t, p, p, d, d, scales6, depth=5, act="relu",
                                     same=True)
    with pytest.raises(ValueError, match="h <= 32"):
        MG.myrtle_gram_tangents_cuda(x64, x64, p, p, d, d, scales6, depth=5, act="relu")


def test_bf16_wrapper_refuses_what_the_kernel_does_not_take():
    x, _ = _data(2, 1, 8)
    t = torch.as_tensor(x)
    p = MG.pack_profiles(MG.myrtle_var_profiles(t, (1, 1, 1), "relu", 1.0, 0.1))
    scales = torch.tensor([1.0, 0.01, 1.0, 1 / 3])
    # Only a normalised state (None or torch.bfloat16) reaches the wrapper.
    for state in (torch.float16, torch.float32, "bf16"):
        with pytest.raises(ValueError, match="None \\(float32\\) or torch.bfloat16"):
            MG.myrtle_gram_cuda(t, t, p, p, scales, depth=5, act="relu", state=state)
    # A CPU tensor never reaches a kernel, in either state.
    with pytest.raises(ValueError, match="CUDA"):
        MG.myrtle_gram_cuda(t, t, p, p, scales, depth=5, act="relu", state=torch.bfloat16)


@pytest.mark.parametrize("wrapper,other", [("tangents", "x"), ("tangents", "prof"),
                                           ("tangents", "dprof"), ("forward", "x"),
                                           ("forward", "prof")])
def test_tangent_wrapper_refuses_same_for_two_operands(wrapper, other):
    """same=True mirrors the upper triangle, so both wrappers take it only
    when x2, prof2 (and dprof2) are x1's, prof1's (and dprof1's)."""
    t = torch.as_tensor(_data(2, 1, 8)[0])
    p = MG.pack_profiles(MG.myrtle_var_profiles(t, (1, 1, 1), "relu", 1.0, 0.1))
    d = MG.pack_profiles(MG.myrtle_profile_tangents(t, depth=5)[1])
    args = dict(x=t, prof=p, dprof=d)
    twice = {k: (v, v.clone() if k == other else v) for k, v in args.items()}
    with pytest.raises(ValueError, match=f"same=True.*{other}2 is not {other}1"):
        if wrapper == "forward":
            MG.myrtle_gram_cuda(*twice["x"], *twice["prof"], torch.tensor([1.0, 0.01, 1.0, 1 / 3]),
                                depth=5, act="relu", same=True)
        else:
            MG.myrtle_gram_tangents_cuda(*twice["x"], *twice["prof"], *twice["dprof"],
                                         torch.tensor([1.0, 0.01, 1.0, 1 / 3, 1.0, 0.1]),
                                         depth=5, act="relu", same=True)


@pytest.mark.parametrize("h", [8, 16, 32])
@pytest.mark.parametrize("ns", [1, 2, 3])
def test_tangent_block_fits_shared_memory(h, ns):
    """Both modes run WARPS (16) warps a block at every image size
    they take: the ring, the stage-3 state, a column-sum plane a warp and
    the float64 reduction scratch fit a block's 232,448 bytes, with stage 1
    in registers (no per-warp slab planes). The forward (ns = 1) fits two
    blocks in an SM's 228 KB (each block also holds 1 KB for the system)."""
    assert MG.WARPS == 16
    floats = MG.tangent_smem_floats(h, ns)
    assert floats == 2 * ns * (h // 2) ** 3 + ns * (h // 4) ** 4 + 16 * (h // 2) ** 2
    block = 4 * floats + 8 * 3 * MG.WARPS
    assert block <= 232_448
    if ns == 1:
        assert 2 * (block + 1024) <= 228 * 1024


def test_tangent_mode_asks_for_same_exactly_for_one_operand(monkeypatch):
    """_tangents, myrtle_gram_scale_grads, _MyrtleGram.backward and the
    kernel_fn of nn.arch ask the tangent kernel for its symmetric launch
    exactly when both operands are one tensor. The device dispatch is
    patched to take the kernels' path, whose wrappers run the plain
    versions here."""
    from snngp_torch.nn import arch
    seen = []

    def tangents_spy(*args, same=False, **kw):
        seen.append(same)
        return MG.myrtle_gram_tangents_plain(*args, **kw)

    monkeypatch.setattr(MG, "_use_kernel", lambda x, plain: not plain)
    monkeypatch.setattr(MG, "myrtle_gram_tangents_cuda", tangents_spy)
    monkeypatch.setattr(MG, "myrtle_gram_cuda",
                        lambda *a, same=False, **kw: MG.myrtle_gram_plain(*a, **kw))
    x1, x2 = _t(*_data(3, 3, 8, seed=12))
    w, b, last = (torch.tensor(v) for v in (1.2, 0.25, 0.9))
    MG._tangents(x1, x1, w, b, last, 5, "relu")
    MG._tangents(x1, x2, w, b, last, 5, "relu")
    assert seen == [True, False]
    seen.clear()
    MG.myrtle_gram_scale_grads(x1, **SG)
    MG.myrtle_gram_scale_grads(x1, x1, **SG)
    MG.myrtle_gram_scale_grads(x1, x1.clone(), **SG)
    MG.myrtle_gram_scale_grads(x1, x2, **SG)
    assert seen == [True, True, False, False]
    for x, y, want in ((x1, None, True), (x1, x1, True), (x1, x2, False)):
        seen.clear()
        ws = torch.tensor(1.2, requires_grad=True)
        k = MG.myrtle_gram(x, y, depth=5, act="relu", w_std=ws, trainable_inputs=False)
        k.sum().backward()
        assert seen == [want] and ws.grad is not None
        seen.clear()
        ws = torch.tensor(1.2, requires_grad=True)
        kfn = arch.get_myrtle_kernel(5, 1, "relu", w_std=ws, trainable_inputs=False)
        (kfn(x) if y is None else kfn(x, y)).sum().backward()
        assert seen == [want]
    # The symmetric launch does not change the values the plain path gives.
    sym = MG.myrtle_gram_scale_grads(x1, **SG)
    monkeypatch.setattr(MG, "_use_kernel", lambda x, plain: False)
    for g, r in zip(sym, MG.myrtle_gram_scale_grads(x1, **SG)):
        np.testing.assert_array_equal(to_numpy(g), to_numpy(r))


def test_forward_asks_for_same_exactly_for_one_operand(monkeypatch):
    """_forward, myrtle_gram, the kernel_fn of nn.arch and the diagonal
    blocks of myrtle_gram_tiled ask K7 for its symmetric launch exactly when
    both operands are one tensor. The device dispatch is patched to take the
    kernels' path, whose wrapper runs the plain version here."""
    from snngp_torch.nn import arch
    seen = []

    def forward_spy(*args, same=False, **kw):
        seen.append(same)
        if same:
            assert args[1] is args[0] and args[3] is args[2]
        return MG.myrtle_gram_plain(*args, **kw)

    monkeypatch.setattr(MG, "_use_kernel", lambda x, plain: not plain)
    monkeypatch.setattr(MG, "myrtle_gram_cuda", forward_spy)
    x1, x2 = _t(*_data(3, 3, 8, seed=12))
    w, b, last = (torch.tensor(v) for v in (1.2, 0.25, 0.9))
    MG._forward(x1, x1, w, b, last, 5, "relu", True)
    MG._forward(x1, x2, w, b, last, 5, "relu", False)
    assert seen == [True, False]
    seen.clear()
    kfn = arch.get_myrtle_kernel(5, 1, "relu", w_std=1.2)
    for y in (None, x1, x1.clone(), x2):
        MG.myrtle_gram(x1, y, **SG)
        kfn(x1) if y is None else kfn(x1, y)
    assert seen == [True, True, True, True, False, False, False, False]
    # Tiled: 5 images in blocks of 2 -> blocks (0, 0), (0, 2), (0, 4), (2, 2),
    # (2, 4), (4, 4), whose diagonal ones launch symmetrically; a rectangular
    # Gram has no diagonal block.
    x5 = torch.as_tensor(_data(5, 1, 8, seed=4)[0])
    seen.clear()
    sym = MG.myrtle_gram_tiled(x5, block=2, **SG)
    assert seen == [True, False, False, True, False, True]
    seen.clear()
    MG.myrtle_gram_tiled(x5, x5, block=2, **SG)
    assert seen == [False] * 9
    # The symmetric launches do not change the values the plain path gives.
    monkeypatch.setattr(MG, "_use_kernel", lambda x, plain: False)
    np.testing.assert_array_equal(sym, MG.myrtle_gram_tiled(x5, block=2, **SG))
    np.testing.assert_array_equal(to_numpy(MG.myrtle_gram(x1, **SG)),
                                  to_numpy(MG.myrtle_gram(x1, x1.clone(), **SG)))


def test_kernels_match_plain_on_the_card(cuda_device):
    x1, x2 = _data(3, 5, 16, seed=11)
    a, b = (torch.as_tensor(v, device=cuda_device) for v in (x1, x2))
    before = dict(MG.LAUNCHES)
    got = [MG.myrtle_gram(a, b, **HP), *MG.myrtle_gram_scale_grads(a, b, **SG)]
    want = [MG.myrtle_gram(*_t(x1, x2), **HP), *MG.myrtle_gram_scale_grads(*_t(x1, x2), **SG)]
    assert MG.LAUNCHES["myrtle"] == before["myrtle"] + 1
    assert MG.LAUNCHES["myrtle_grads"] == before["myrtle_grads"] + 1
    for g, w in zip(got, want):
        assert ((g.cpu() - w).abs().max() / w.abs().max()).item() <= 1e-5
    # The symmetric wb launch on a ragged pair count: bitwise symmetric.
    # erf: within 1e-5 of the plain version. relu: its same-image pairs meet
    # c = 1, where sqrt(1 - c^2) amplifies fp32 round-off, so the kernel is
    # held against float64: within 2x the plain fp32 version's error (floor
    # 1e-6), the bar of chip_smoke.py's gradient checks.
    def rel(a, b):
        a, b = a.cpu().double(), b.double()
        return ((a - b).abs().max() / b.abs().max()).item()

    x7 = torch.as_tensor(_data(7, 1, 16, seed=12)[0])
    # The symmetric forward: bitwise symmetric, within 1e-5 of the plain
    # version (relu's forward is well conditioned at c = 1).
    k7 = MG.myrtle_gram(x7.to(cuda_device), **HP)
    plain = MG.myrtle_gram(x7, **HP)
    assert torch.equal(k7, k7.T)
    assert rel(k7, plain) <= 1e-5
    assert MG.LAUNCHES["myrtle"] == before["myrtle"] + 2
    for act in ("erf", "relu"):
        kw = dict(SG, act=act)
        got = MG.myrtle_gram_scale_grads(x7.to(cuda_device), **kw)
        plain = MG.myrtle_gram_scale_grads(x7, **kw)
        ref = MG.myrtle_gram_scale_grads(x7.double(), **kw)
        for g, p, r in zip(got, plain, ref):
            assert torch.equal(g, g.T)
            if act == "erf":
                assert rel(g, p) <= 1e-5
            else:
                assert rel(g, r) <= 2.0 * max(rel(p, r), 1e-6)
    assert MG.LAUNCHES["myrtle_grads"] == before["myrtle_grads"] + 3


# -- the bf16 pair state ---------------------------------------------------------------

# Ceilings of assert_fp32_reach on the bf16 pair state: K7's bf16 plain
# version and the JAX bf16 kernel, each against the float64 plain version,
# of max|K|, within 4x the largest distance either showed (beside each; the
# same on every MKL code path) and, on the port, under its earlier bar of 2x
# the JAX kernel's distance.
BF16_REACH = {"relu": 7e-3,    # largest 3.61e-3: the JAX kernel (the port 3.47e-3)
              "erf": 2.5e-2}   # largest 1.49e-2: the JAX kernel (the port 3.51e-3)


@functools.lru_cache(maxsize=None)
def _bf16_case(act):
    """(x1, x2, the JAX bf16 kernel's K in interpret mode, the float64 plain
    version's K) at Myrtle-5, 3 x 2 pairs of 8 x 8 x 3 images."""
    x1, x2 = _data(3, 2, 8, seed=21)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mg, "INTERPRET", True)
        want = np.asarray(mg.myrtle_gram(x1, x2, depth=5, act=act, dtype="bf16", **HP),
                          np.float64)
    exact = MG.myrtle_gram(*_t(x1.astype(np.float64), x2.astype(np.float64)), depth=5,
                           act=act, **HP)
    return x1, x2, want, to_numpy(exact)


@pytest.mark.parametrize("act", ["relu", "erf"])
def test_bf16_plain_matches_jax_interpret(act):
    """K7's bf16 plain version against the JAX package's bf16 kernel in
    interpret mode: each within BF16_REACH of the float64 plain version,
    and the two within 2x the JAX kernel's distance (floor 1e-3 of max|K|)
    of each other. The two round the bf16 state at other points: the JAX
    kernel pools each side in its own fp32 pass and adds its tail stages'
    lane pools in bf16. The port also stays at least 2^-10 of max|K| from
    float64: bf16 keeps 8 significant bits, and a recursion that rounds
    every op to them lands ~3.5e-3 away on these inputs, where an fp32
    recursion lands ~2e-7 away."""
    x1, x2, want, exact = _bf16_case(act)
    got = MG.myrtle_gram(*_t(x1, x2), depth=5, act=act, dtype=torch.bfloat16, **HP)
    assert got.dtype == torch.float32
    d_port, d_jax = assert_fp32_reach(got, want, exact, BF16_REACH[act], f"bf16 {act} K")
    d_pair = np.abs(to_numpy(got).astype(np.float64) - want).max() / np.abs(exact).max()
    print(f"bf16 {act}: port against JAX interpret {d_pair:.3e}")
    assert 2.0 ** -10 <= d_port, d_port
    assert d_pair <= 2.0 * max(d_jax, 1e-3), (d_pair, d_jax)


@pytest.mark.parametrize("act", ["relu", "erf"])
def test_bf16_reach_refuses_a_wrong_scale(act):
    """Each BF16_REACH ceiling refuses K7's bf16 plain version with
    last_w_std 2% high (K 4.04% high): 3.79e-2 (relu) and 3.94e-2 (erf) of
    max|K| from float64."""
    x1, x2, want, exact = _bf16_case(act)
    wrong = MG.myrtle_gram(*_t(x1, x2), depth=5, act=act, dtype=torch.bfloat16,
                           **dict(HP, last_w_std=HP["last_w_std"] * 1.02))
    with pytest.raises(AssertionError, match="the port errs"):
        assert_fp32_reach(wrong, want, exact, BF16_REACH[act], f"bf16 {act} K")


@pytest.mark.parametrize("tangents", [False, True])
def test_plain_versions_keep_a_float64_witness_in_float64(tangents):
    """The plain versions run in their inputs' dtype: float64 inputs (the
    witnesses of the card's gradient and tangent checks) give a float64
    recursion, not the fp32 one cast up."""
    x = torch.as_tensor(_data(3, 1, 8, seed=24)[0])
    if tangents:
        k32 = MG.myrtle_gram_scale_grads(x, **SG)
        k64 = MG.myrtle_gram_scale_grads(x.double(), **SG)
    else:
        k32 = (MG.myrtle_gram(x, **SG),)
        k64 = (MG.myrtle_gram(x.double(), **SG),)
    for a, b in zip(k32, k64):
        assert b.dtype == torch.float64
        assert not torch.equal(b, a.double())
        assert ((b - a.double()).abs().max() / b.abs().max()).item() <= 1e-5


def test_bf16_spellings_tiles_and_shards():
    """The three bf16 spellings give one result, which is not the fp32
    one; myrtle_gram_tiled and myrtle_gram_sharded pass the dtype through
    (their blocks within 1e-6 of max|K| of one call)."""
    from snngp_torch.parallel.mesh import gather, get_mesh

    x = torch.as_tensor(_data(5, 1, 8, seed=22)[0])
    outs = [MG.myrtle_gram(x, dtype=d, **SG) for d in (torch.bfloat16, "bf16", "bfloat16")]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert outs[0].dtype == torch.float32
    assert not torch.equal(outs[0], MG.myrtle_gram(x, **SG))
    scale = outs[0].abs().max().item()
    tiled = MG.myrtle_gram_tiled(x, block=2, dtype="bf16", **SG)
    np.testing.assert_allclose(tiled, to_numpy(outs[0]), rtol=0, atol=1e-6 * scale)
    x4 = x[:4]
    sharded = gather(MG.myrtle_gram_sharded(x4, None, get_mesh(2, device="cpu"), dtype="bf16",
                                            **SG))
    np.testing.assert_allclose(to_numpy(sharded), to_numpy(MG.myrtle_gram(x4, dtype="bf16", **SG)),
                               rtol=0, atol=1e-6 * scale)


def test_bf16_request_reaches_the_bf16_kernel(monkeypatch):
    """On the kernels' path (the device dispatch patched; the spy runs the
    plain version here) a bf16 request launches the bf16 variant, and an
    fp32 request the fp32 kernel: no request reaches the other one."""
    seen = []

    def spy(*args, same=False, state=None, **kw):
        seen.append(state)
        return MG.myrtle_gram_plain(*args, **kw, state=state)

    monkeypatch.setattr(MG, "_use_kernel", lambda x, plain: not plain)
    monkeypatch.setattr(MG, "myrtle_gram_cuda", spy)
    x = torch.as_tensor(_data(3, 1, 8, seed=23)[0])
    MG.myrtle_gram(x, dtype="bf16", **SG)
    MG.myrtle_gram(x, **SG)
    MG.myrtle_gram_tiled(x, block=2, dtype=torch.bfloat16, **SG)
    assert seen == [torch.bfloat16, None] + [torch.bfloat16] * 3


def test_bf16_kernel_matches_its_plain_version_on_the_card(cuda_device):
    """The bf16 variant on the card: launched under its own count, within
    1e-4 of max|K| of the bf16 plain version, and its distance from the
    fp32 kernel within [0.5x, 2x] the plain bf16 version's (the upper side
    floored at 1e-3): the gates of chip_smoke.py's bf16 phase."""
    x1, x2 = _data(3, 5, 16, seed=13)
    a, b = (torch.as_tensor(v, device=cuda_device) for v in (x1, x2))
    before = dict(MG.LAUNCHES)
    got = MG.myrtle_gram(a, b, dtype="bf16", **HP).cpu()
    assert MG.LAUNCHES["myrtle_bf16"] == before["myrtle_bf16"] + 1
    assert MG.LAUNCHES["myrtle"] == before["myrtle"]
    f32 = MG.myrtle_gram(a, b, **HP).cpu()
    plain = MG.myrtle_gram(*_t(x1, x2), dtype="bf16", **HP)
    scale = f32.abs().max()
    assert ((got - plain).abs().max() / scale).item() <= 1e-4
    d_plain = ((plain - f32).abs().max() / scale).item()
    d_kernel = ((got - f32).abs().max() / scale).item()
    assert 0.5 * d_plain <= d_kernel <= 2.0 * max(d_plain, 1e-3)
    sym = MG.myrtle_gram(a, dtype="bf16", **HP)
    assert torch.equal(sym, sym.T) and bool(torch.isfinite(sym).all())
