"""Port parity of the CNN NNGP: the conv layer tier (snngp_torch/nn/layers.py:
``_patch_mean``, ``Conv``, ``Flatten``), the ``cnn`` builders
(snngp_torch/nn/arch.py) and the fused conv Gram with its two backward
contracts (snngp_torch/ops/conv_gram.py: K3's and K4's plain versions),
each against the JAX package on the same numpy inputs; and, on a CUDA card
only, K3 and K4 against their plain versions.

The JAX Pallas kernels run in interpreter mode on the CPU
(``conv_gram.INTERPRET``, set and restored per test, as
tests/test_pallas.py does). Tolerances:
- the stencil mean and the variance maps: atol 2e-7 (one fp32 conv of
  values ~1 each side, reassociated);
- Grams of the layer tier, the fused Gram and its four tangent Grams:
  atol 1e-6 on Grams of magnitude <= 1 (max 2e-6 for the 32 x 32 x 3 case),
  the fp32 bar of the JAX package's own conv-kernel tests
  (tests/test_pallas.py:92-129); acos / asin and the input moment differ in
  the last bits only;
- gradients (x cotangents and the three scalar sums): rtol 1e-5 with an
  atol of 1e-6 of the largest entry, the bar of tests/test_torch_grad.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snngp.ops.pallas.conv_gram as JCG
from snngp.nn import arch as jarch
from snngp.nn import layers as JL
from snngp.nn.state import KernelState as JS
from snngp.nn.state import input_state as j_input_state

from snngp_torch.nn import arch as tarch
from snngp_torch.nn import layers as TL
from snngp_torch.nn.state import KernelState as TS
from snngp_torch.nn.state import input_state as t_input_state
from snngp_torch.ops import conv_gram as TCG

from _torch_parity import cuda_device, randn, to_numpy, to_torch  # noqa: F401

SCALES = dict(w_std=1.3, b_std=0.2, last_w_std=0.9)
# (name, [N1, H, W, C] of x1, N2): the synthetic set's 8 x 8 x 1, a ragged
# 6 x 5 x 2, and the CIFAR shape at N <= 4.
SHAPES = {"8x8x1": ((5, 8, 8, 1), 3), "6x5x2": ((4, 6, 5, 2), 3),
          "32x32x3": ((3, 32, 32, 3), 4)}


@pytest.fixture(autouse=True)
def _interpret_mode():
    JCG.INTERPRET = True
    yield
    JCG.INTERPRET = False


def _images(seed, name, same=False):
    (n1, h, w, c), n2 = SHAPES[name]
    x1, x2 = randn(seed, (n1, h, w, c), (n2, h, w, c))
    return (x1, x1) if same else (x1, x2)


def _atol(name):
    return 2e-6 if name == "32x32x3" else 1e-6


# -- the conv layer tier ---------------------------------------------------------

@pytest.mark.parametrize("strides", [(1, 1), (2, 2)])
@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (6, 5), (8, 7), (1, 1)])
def test_patch_mean_matches_lax_same_alignment(hw, strides):
    # Stride 2 pads an even extent at the high end only (lax SAME).
    (img,) = randn(1, (3,) + hw)
    want = np.asarray(JL._patch_mean(jnp.asarray(img), (3, 3), strides))
    got = to_numpy(TL._patch_mean(to_torch(img), (3, 3), strides))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-7)


@pytest.mark.parametrize("strides", [(1, 1), (2, 2)])
def test_conv_layer_matches(strides):
    x1, x2 = _images(2, "6x5x2")
    want = JL.Conv(1, (3, 3), strides, w_std=1.2, b_std=0.3).kfn(j_input_state(x1, x2))
    got = TL.Conv(1, (3, 3), strides, w_std=1.2, b_std=0.3).kfn(
        t_input_state(*to_torch(x1, x2)))
    assert got.spatial and got.nngp.shape == want.nngp.shape
    for field in ("nngp", "var1", "var2"):
        np.testing.assert_allclose(to_numpy(getattr(got, field)),
                                   np.asarray(getattr(want, field)), atol=1e-6)


def test_conv_requires_a_spatial_state_and_flatten_passes_a_flat_one():
    v = np.ones(3, np.float32)
    flat = TS(nngp=to_torch(np.eye(3, dtype=np.float32)), var1=to_torch(v), var2=to_torch(v))
    with pytest.raises(ValueError, match="spatial"):
        TL.Conv(1).kfn(flat)
    assert TL.Flatten().kfn(flat) is flat
    want = JL.Flatten().kfn(JS(nngp=np.eye(3, dtype=np.float32), var1=v, var2=v))
    assert want.nngp.shape == (3, 3)


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("name", ["8x8x1", "6x5x2"])
def test_cnn_layer_tier_matches(name, act):
    x1, x2 = _images(3, name)
    want = JL.kernel_fn_of(jarch.get_cnn_layer(2, 1, act, **SCALES))(x1, x2, get="nngp")
    got = TL.kernel_fn_of(tarch.get_cnn_layer(2, 1, act, **SCALES))(*to_torch(x1, x2))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-6)


# -- the fused conv Gram (K3's plain version) -------------------------------------

@pytest.mark.parametrize("act", ["relu", "erf"])
def test_conv_var_stack_and_tangents_match(act):
    (x,) = randn(4, (4, 6, 5, 2))
    w, b = jnp.float32(1.3), jnp.float32(0.2)
    want_v, want_dv = JCG._conv_var_stack_with_tangents(jnp.asarray(x), 3, act, w, b)
    got_v, got_dv = TCG._stack_with_tangents(to_torch(x), 3, act, torch.tensor(1.3),
                                             torch.tensor(0.2))
    np.testing.assert_allclose(to_numpy(got_v), np.asarray(want_v).reshape(4, 4, 30),
                               atol=2e-7)
    np.testing.assert_allclose(to_numpy(got_dv), np.asarray(want_dv).reshape(2, 4, 4, 30),
                               atol=1e-6)


@pytest.mark.parametrize("same", [False, True], ids=["x1,x2", "x,x"])
@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_cnn_gram_matches_jax_interpret(name, act, same):
    x1, x2 = _images(5, name, same)
    want = np.asarray(JCG.cnn_gram(x1, x1 if same else x2, depth=2, act=act, **SCALES))
    a, b = to_torch(x1, x2)
    got = to_numpy(TCG.cnn_gram(a, a if same else b, depth=2, act=act, **SCALES))
    np.testing.assert_allclose(got, want, atol=_atol(name))
    if same:  # K(x, x) of the plain version is symmetric to round-off
        np.testing.assert_allclose(got, got.T, atol=1e-7)


@pytest.mark.parametrize("act", ["relu", "erf"])
def test_get_cnn_kernel_matches_jax(act):
    # JAX's kernel_fn takes its layer tier on the CPU; the port's goes to
    # the fused Gram's plain version. x2=None means K(x, x).
    (x,) = randn(6, (6, 8, 8, 1))
    want = np.asarray(jarch.get_cnn_kernel(3, 1, act, **SCALES)(x, None, get="nngp"))
    got = to_numpy(tarch.get_cnn_kernel(3, 1, act, **SCALES)(to_torch(x), None))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_get_cnn_kernel_routes_by_image_size(monkeypatch):
    # h w <= 1024 goes to cnn_gram; larger images take the layer tier.
    calls = []
    real = TCG.cnn_gram
    monkeypatch.setattr(TCG, "cnn_gram", lambda *a, **k: calls.append(1) or real(*a, **k))
    kfn = tarch.get_cnn_kernel(1, 1, "relu", **SCALES)
    small, big = randn(7, (2, 32, 32, 1), (2, 33, 32, 1))
    kfn(to_torch(small))
    assert len(calls) == 1
    got = kfn(to_torch(big))
    assert len(calls) == 1
    want = JL.kernel_fn_of(jarch.get_cnn_layer(1, 1, "relu", **SCALES))(big, None, get="nngp")
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-6)


# -- K3's and K4's streamed launch (pure Python: what the wrapper passes) -------------------

# (h, w) -> (lanes, rows, lg, rstride, cstride): the widths of the CIFAR,
# MNIST and synthetic images and of the WideResNet's groups, and images
# wider than 32, which stream transposed.
GEOMETRY = {(32, 32): (32, 32, 5, 32, 1), (28, 28): (28, 28, 5, 28, 1),
            (16, 16): (16, 16, 4, 16, 1), (8, 8): (8, 8, 3, 8, 1), (7, 7): (7, 7, 3, 7, 1),
            (4, 4): (4, 4, 2, 4, 1), (6, 5): (5, 6, 3, 5, 1), (5, 40): (5, 40, 3, 1, 40),
            (8, 100): (8, 100, 3, 1, 100), (1, 1024): (1, 1024, 0, 1, 1024),
            (1024, 1): (1, 1024, 0, 1, 1)}


@pytest.mark.parametrize("hw", list(GEOMETRY), ids=[f"{h}x{w}" for h, w in GEOMETRY])
def test_stream_geometry_segments_and_transposes(hw):
    lanes, rows, lg, rs, cs = TCG.stream_geometry(*hw)
    assert (lanes, rows, lg, rs, cs) == GEOMETRY[hw]
    assert lanes <= 2 ** lg < 2 * lanes
    assert lanes * rows == hw[0] * hw[1]
    # Element (r, c) of the streamed state is pixel r * rs + c * cs: each
    # pixel once.
    pix = sorted(r * rs + c * cs for r in range(rows) for c in range(lanes))
    assert pix == list(range(hw[0] * hw[1]))


def _transposed(x, v, h, w):
    """Images [N, H, W, C] and variance maps [L, N, H W] of the transposed
    images."""
    t = v.reshape(v.shape[:2] + (h, w)).transpose(-1, -2)
    return x.transpose(1, 2).contiguous(), t.reshape(v.shape).contiguous()


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("hw", [(9, 7), (5, 40), (3, 48), (1, 33)],
                         ids=["9x7", "5x40", "3x48", "1x33"])
def test_conv_gram_plain_is_unchanged_by_transposing_the_images(hw, act):
    # The identity the wide-image launch rests on: the 3 x 3 SAME mean
    # commutes with transposition, only its sums' order changes (1e-6 of
    # max|K|).
    h, w = hw
    x1, x2 = to_torch(*randn(21, (4, h, w, 2), (3, h, w, 2)))
    wt, bt = torch.tensor(1.3), torch.tensor(0.2)
    v1 = TCG._flat_stack(x1, 3, act, wt, bt)
    v2 = TCG._flat_stack(x2, 3, act, wt, bt)
    scales = torch.tensor([1.69, 0.04, 0.81, 0.5])
    want = TCG.conv_gram_plain(x1, x2, v1, v2, scales, depth=3, act=act)
    t1, u1 = _transposed(x1, v1, h, w)
    t2, u2 = _transposed(x2, v2, h, w)
    got = TCG.conv_gram_plain(t1, t2, u1, u2, scales, depth=3, act=act)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("other", ["x", "v"])
def test_conv_gram_cuda_refuses_same_for_two_operands(other):
    """same=True mirrors the lower triangle, so the wrapper takes it only
    when x2 and v2s are x1's and v1s."""
    x1, _ = _images(9, "8x8x1")
    a = to_torch(x1)
    v = TCG._flat_stack(a, 2, "relu", torch.tensor(1.3), torch.tensor(0.2))
    args = dict(x=(a, a.clone() if other == "x" else a), v=(v, v.clone() if other == "v" else v))
    with pytest.raises(ValueError, match=f"same=True.*{other}2 is not {other}1"):
        TCG.conv_gram_cuda(*args["x"], *args["v"], torch.ones(4), depth=2, act="relu",
                           same=True)


@pytest.mark.parametrize("other", ["x", "v", "dv"])
def test_conv_gram_grads_cuda_refuses_same_for_two_operands(other):
    """K4's same=True runs each pair j <= i once, so the wrapper takes it
    only when x2, v2s and dv2s are x1's, v1s and dv1s."""
    x1, _ = _images(9, "8x8x1")
    a = to_torch(x1)
    v, dv = TCG._stack_with_tangents(a, 2, "relu", torch.tensor(1.3), torch.tensor(0.2))
    ops = dict(x=(a, a), v=(v, v), dv=(dv, dv))
    ops[other] = (ops[other][0], ops[other][0].clone())
    with pytest.raises(ValueError, match=f"same=True.*{other}2 is not {other}1"):
        TCG.conv_gram_grads_cuda(*ops["x"], *ops["v"], *ops["dv"], torch.ones(7),
                                 torch.ones(5, 5), depth=2, act="relu", same=True)


def test_cuda_wrappers_reject_cpu_tensors_and_count_no_launch():
    x1, x2 = _images(8, "8x8x1")
    a, b = to_torch(x1, x2)
    before = dict(TCG.LAUNCHES)
    TCG.cnn_gram(a, b, depth=2, act="relu", **SCALES)
    assert TCG.LAUNCHES == before              # CPU tensors never reach a kernel
    v1 = TCG._flat_stack(a, 2, "relu", torch.tensor(1.3), torch.tensor(0.2))
    with pytest.raises(ValueError, match="CUDA"):
        TCG.conv_gram_cuda(a, a, v1, v1, torch.ones(4), depth=2, act="relu")
    with pytest.raises(KeyError):
        TCG.cnn_gram(a, b, depth=2, act="tanh", **SCALES)


# -- the two backward contracts -------------------------------------------------

@pytest.mark.parametrize("same", [False, True], ids=["x1,x2", "x,x"])
@pytest.mark.parametrize("act", ["relu", "erf"])
def test_trainable_inputs_backward_matches_jax_vjp(act, same):
    # x1, x2 and scale cotangents through the layer tier (SVSP's contract).
    x1, x2 = _images(9, "6x5x2", same)
    (g,) = randn(10, (x1.shape[0], x2.shape[0]))

    def f(a, bb, w, bs, last):
        return JCG.cnn_gram(a, a if same else bb, depth=2, act=act, w_std=w, b_std=bs,
                            last_w_std=last)

    _, vjp = jax.vjp(f, x1, x2, 1.3, 0.2, 0.9)
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    leaves = [torch.tensor(v, requires_grad=True) for v in (x1, x2, 1.3, 0.2, 0.9)]
    a, bb, w, bs, last = leaves
    k = TCG.cnn_gram(a, a if same else bb, depth=2, act=act, w_std=w, b_std=bs,
                     last_w_std=last)
    wanted = [a, w, bs, last] if same else leaves
    got = torch.autograd.grad(k, wanted, to_torch(g))
    for gt, wt in zip(got, [want[0]] + want[2:] if same else want):
        np.testing.assert_allclose(to_numpy(gt), wt, rtol=1e-5,
                                   atol=1e-6 * np.abs(wt).max())


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("name", ["8x8x1", "6x5x2"])
def test_tangent_grams_match_jax_cnn_gram_grads(name, act):
    # K4's plain version returns the four Grams the TPU kernel writes.
    x1, x2 = _images(11, name)
    want = JCG._cnn_gram_grads(2, act, JCG._auto_tile(x1.shape[1] * x1.shape[2], 2, 3),
                               x1, x2, 1.3, 0.2, 0.9)
    a, b = to_torch(x1, x2)
    w, bs, last = (torch.tensor(v) for v in (1.3, 0.2, 0.9))
    v1, dv1 = TCG._stack_with_tangents(a, 2, act, w, bs)
    v2, dv2 = TCG._stack_with_tangents(b, 2, act, w, bs)
    scales = torch.stack([w * w, bs * bs, last * last, torch.tensor(1.0 / x1.shape[-1]),
                          w, bs, last])
    got = TCG.conv_gram_tangents_plain(a, b, v1, v2, dv1, dv2, scales, depth=2, act=act)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(to_numpy(gt), np.asarray(wt), atol=2e-6)


@pytest.mark.parametrize("same", [False, True], ids=["x1,x2", "x,x"])
@pytest.mark.parametrize("act", ["relu", "erf"])
def test_scalar_backward_matches_jax(act, same):
    # trainable_inputs=False: the three sums g . dK/d(w, b, last) against
    # jax.grad through the JAX package's scalar-tangent kernel
    # (_cnn_gram_grads in interpret mode); x cotangents are zero.
    x1, x2 = _images(12, "8x8x1", same)
    (g,) = randn(13, (x1.shape[0], x2.shape[0]))

    def f(w, bs, last):
        k = JCG.cnn_gram(x1, x1 if same else x2, depth=2, act=act, w_std=w, b_std=bs,
                         last_w_std=last, trainable_inputs=False)
        return jnp.sum(jnp.asarray(g) * k)

    want = np.asarray(jax.grad(f, argnums=(0, 1, 2))(1.3, 0.2, 0.9))
    a, b = to_torch(x1, x2)
    a.requires_grad_(True)
    w, bs, last = (torch.tensor(v, requires_grad=True) for v in (1.3, 0.2, 0.9))
    k = TCG.cnn_gram(a, a if same else b, depth=2, act=act, w_std=w, b_std=bs,
                     last_w_std=last, trainable_inputs=False)
    *got, gx = torch.autograd.grad(k, (w, bs, last, a), to_torch(g))
    np.testing.assert_allclose(np.array([t.item() for t in got]), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert not gx.any()


def test_scalar_sums_plain_is_the_float64_contraction():
    x1, x2 = _images(14, "6x5x2")
    (g,) = randn(15, (x1.shape[0], x2.shape[0]))
    a, b, gt = to_torch(x1, x2, g)
    w, bs, last = (torch.tensor(v) for v in (1.3, 0.2, 0.9))
    v1, dv1 = TCG._stack_with_tangents(a, 2, "relu", w, bs)
    v2, dv2 = TCG._stack_with_tangents(b, 2, "relu", w, bs)
    scales = torch.stack([w * w, bs * bs, last * last, torch.tensor(0.5), w, bs, last])
    args = (a, b, v1, v2, dv1, dv2, scales)
    sums = TCG.conv_gram_grads_plain(*args, gt, depth=2, act="relu")
    assert sums.dtype == torch.float64
    _, dkw, dkb, dkl = TCG.conv_gram_tangents_plain(*args, depth=2, act="relu")
    for s, t in zip(sums, (dkw, dkb, dkl)):
        np.testing.assert_allclose(s.item(), float(np.sum(g.astype(np.float64)
                                                          * to_numpy(t))), rtol=1e-12)


@pytest.mark.parametrize("act", ["relu", "erf"])
def test_cuda_kernels_match_plain_versions(cuda_device, act):
    # K3 within 1e-5 of max|K| and K4's sums within 1e-5 of sum |g dK| of
    # their plain versions, the bench.py bar. Runs only on a CUDA card.
    x1, x2 = randn(16, (37, 9, 7, 2), (21, 9, 7, 2))
    (g,) = randn(17, (37, 21))
    with torch.inference_mode():
        a, b, gt = (t.to(cuda_device) for t in to_torch(x1, x2, g))
        w, bs, last = (torch.tensor(v, device=cuda_device) for v in (1.3, 0.2, 0.9))
        v1, dv1 = TCG._stack_with_tangents(a, 3, act, w, bs)
        v2, dv2 = TCG._stack_with_tangents(b, 3, act, w, bs)
        inv_c = torch.tensor(0.5, device=cuda_device)
        s4 = torch.stack([w * w, bs * bs, last * last, inv_c])
        k = TCG.conv_gram_cuda(a, b, v1, v2, s4, depth=3, act=act)
        k_plain = TCG.conv_gram_plain(a, b, v1, v2, s4, depth=3, act=act)
        assert (k - k_plain).abs().max() <= 1e-5 * k_plain.abs().max()
        s7 = torch.stack([w * w, bs * bs, last * last, inv_c, w, bs, last])
        args = (a, b, v1, v2, dv1.contiguous(), dv2.contiguous(), s7, gt)
        sums = TCG.conv_gram_grads_cuda(*args, depth=3, act=act)
        want = TCG.conv_gram_grads_plain(*args, depth=3, act=act)
        _, *tangents = TCG.conv_gram_tangents_plain(*args[:-1], depth=3, act=act)
        scale = torch.stack([(gt.double().abs() * t.double().abs()).sum() for t in tangents])
        assert bool(((sums - want).abs() <= 1e-5 * scale).all())


# (h, w, c, depth): the widths of the synthetic, MNIST and CIFAR images and
# of narrow states (4, 7, 8, 16, 28), an image wider than 32 (transposed),
# and depths that take one pass and three.
STREAMED_CASES = [(4, 4, 1, 3), (7, 7, 2, 4), (8, 8, 1, 4), (16, 16, 3, 2), (28, 28, 1, 4),
                  (5, 40, 1, 3), (6, 5, 2, 10)]


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("h,w,c,depth", STREAMED_CASES,
                         ids=[f"{h}x{w}x{c}-d{d}" for h, w, c, d in STREAMED_CASES])
def test_cuda_streamed_k3_is_symmetric_repeatable_and_matches_plain(cuda_device, act, h, w,
                                                                    c, depth):
    # K3 within 1e-5 of max|K| of its plain version on two operands and on
    # one (same=True), a symmetric launch bitwise symmetric, a second launch
    # bitwise equal. Runs only on a CUDA card.
    x1, x2 = randn(22, (19, h, w, c), (11, h, w, c))
    with torch.inference_mode():
        a, b = (t.to(cuda_device) for t in to_torch(x1, x2))
        wt, bt = (torch.tensor(v, device=cuda_device) for v in (1.3, 0.2))
        v1 = TCG._flat_stack(a, depth, act, wt, bt).contiguous()
        v2 = TCG._flat_stack(b, depth, act, wt, bt).contiguous()
        s4 = torch.tensor([1.69, 0.04, 0.81, 1.0 / c], device=cuda_device)
        for args, same in (((a, b, v1, v2), False), ((a, a, v1, v1), True)):
            k = TCG.conv_gram_cuda(*args, s4, depth=depth, act=act, same=same)
            again = TCG.conv_gram_cuda(*args, s4, depth=depth, act=act, same=same)
            want = TCG.conv_gram_plain(*args, s4, depth=depth, act=act)
            assert (k - want).abs().max() <= 1e-5 * want.abs().max()
            assert torch.equal(k, again)
            if same:
                assert torch.equal(k, k.T)


# (h, w, c, depth): narrow images (7, 8), a rectangular one, an image wider
# than 32 (transposed), and depths of one pass (1, 4: SVSP's) and of three
# passes through the shared planes (10).
K4_CASES = [(8, 8, 1, 4), (7, 7, 2, 1), (6, 10, 3, 10), (5, 40, 1, 4), (8, 8, 3, 10),
            (7, 7, 1, 4), (6, 10, 2, 1), (5, 40, 2, 10)]


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("h,w,c,depth", K4_CASES,
                         ids=[f"{h}x{w}x{c}-d{d}" for h, w, c, d in K4_CASES])
def test_cuda_streamed_k4_is_symmetric_repeatable_and_matches_plain(cuda_device, act, h, w,
                                                                    c, depth):
    # K4's three sums within 1e-5 of sum |g dK| of its plain version on two
    # operands and on one (same=True) with a cotangent that is not
    # symmetric; a second launch bitwise equal; a symmetric launch gives the
    # same bits on g and on g^T (it weights each pair by g[i, j] + g[j, i]).
    # Runs only on a CUDA card.
    x1, x2 = randn(28, (19, h, w, c), (11, h, w, c))
    g1, g2 = randn(29, (19, 11), (19, 19))
    with torch.inference_mode():
        a, b, ga, gs = (t.to(cuda_device) for t in to_torch(x1, x2, g1, g2))
        wt, bt, lt = (torch.tensor(v, device=cuda_device) for v in (1.3, 0.2, 0.9))
        v1, dv1 = TCG._stack_with_tangents(a, depth, act, wt, bt)
        v2, dv2 = TCG._stack_with_tangents(b, depth, act, wt, bt)
        s7 = torch.tensor([1.69, 0.04, 0.81, 1.0 / c, 1.3, 0.2, 0.9], device=cuda_device)
        kw = dict(depth=depth, act=act)
        for args, g, same in (((a, b, v1, v2, dv1, dv2), ga, False),
                              ((a, a, v1, v1, dv1, dv1), gs, True)):
            sums = TCG.conv_gram_grads_cuda(*args, s7, g, **kw, same=same)
            again = TCG.conv_gram_grads_cuda(*args, s7, g, **kw, same=same)
            want = TCG.conv_gram_grads_plain(*args, s7, g, **kw)
            _, *tangents = TCG.conv_gram_tangents_plain(*args, s7, **kw)
            scale = torch.stack([(g.double().abs() * t.double().abs()).sum()
                                 for t in tangents])
            assert bool(((sums - want).abs() <= 1e-5 * scale).all())
            assert torch.equal(sums, again)
            if same:
                flipped = TCG.conv_gram_grads_cuda(*args, s7, g.T.contiguous(), **kw,
                                                   same=True)
                assert torch.equal(sums, flipped)


def test_cuda_symmetric_launch_decodes_pair_indices_past_an_int(cuda_device):
    # A symmetric K3 launch over n = 65,536 one-pixel images: its n (n + 1) /
    # 2 pairs number more than 2^31, so the last rows' pairs decode from
    # indices past an int (tri_pair in csrc/stream.cuh). Rows at both ends
    # and the middle within 1e-5 of max|K| of the plain version on those
    # rows; the whole K (17 GB) bitwise symmetric. Runs only on a CUDA card.
    n = 65_536
    assert n * (n + 1) // 2 > 2**31
    (x,) = randn(26, (n, 1, 1, 2))
    with torch.inference_mode():
        a = to_torch(x).to(cuda_device)
        wt, bt = (torch.tensor(v, device=cuda_device) for v in (1.3, 0.2))
        v = TCG._flat_stack(a, 2, "relu", wt, bt).contiguous()
        s4 = torch.tensor([1.69, 0.04, 0.81, 0.5], device=cuda_device)
        k = TCG.conv_gram_cuda(a, a, v, v, s4, depth=2, act="relu", same=True)
        rows = torch.tensor([0, 1, n // 2, n - 2, n - 1], device=cuda_device)
        want = TCG.conv_gram_plain(a[rows], a, v[:, rows], v, s4, depth=2, act="relu")
        assert (k[rows] - want).abs().max() <= 1e-5 * want.abs().max()
        for r in range(0, n, 4096):
            assert torch.equal(k[r:r + 4096], k[:, r:r + 4096].T)
