"""Port parity of the conv-WideResNet NNGP: the layer-tier builder
(snngp_torch/nn/arch.py ``get_conv_resnet_layer`` / ``get_conv_resnet_kernel``)
and the fused WideResNet Gram (snngp_torch/ops/resnet_conv_gram.py: the
variance maps, K5's and K6's plain versions, ``conv_resnet_gram`` with its
backward), each against the JAX package on the same numpy inputs.

The JAX Pallas kernels run in interpreter mode on the CPU
(``resnet_conv_gram.INTERPRET``, set and restored per test, as
tests/test_pallas.py does), under ``jax.jit`` to keep the file fast.
Tolerances:
- the stencils and the variance maps: atol 1e-6 on values of order 1 (one
  fp32 conv each side, reassociated; the port's closed-form post-activation
  variance against ``_relu_t(v, v, v)``);
- K5, K6 and the whole Gram: 1e-6 of the largest entry (at least 1e-6),
  the fp32 bar of the JAX package's own conv-kernel tests
  (tests/test_pallas.py:92-129); the residual states grow to ~10 over the
  blocks, and acos / asin and the stencils' sums differ in the last bits;
- gradients (x cotangents and the three scales): rtol 1e-5 with an atol of
  1e-6 of the largest entry, the bar of tests/test_torch_grad.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snngp.ops.pallas.resnet_conv_gram as JRG
from snngp.nn import arch as jarch
from snngp.nn import layers as JL
from snngp.nn.state import KernelState as JS

from snngp_torch.nn import arch as tarch
from snngp_torch.nn import layers as TL
from snngp_torch.ops import conv_gram as TCG
from snngp_torch.ops import resnet_conv_gram as TRG

from _torch_parity import cuda_device, randn, to_numpy, to_torch  # noqa: F401

W, B, LAST = 1.1, 0.2, 0.9
SCALES = dict(w_std=W, b_std=B, last_w_std=LAST)
ACTS = ["relu", "erf"]


@pytest.fixture(autouse=True)
def _interpret_mode():
    JRG.INTERPRET = True
    yield
    JRG.INTERPRET = False


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _state(seed, n1, n2, h, w):
    """A matched-pixel state with |k| <= sqrt(v1 v2) (the JAX package's own
    test inputs, tests/test_pallas.py:217-238): k [N1, N2, H, W], v1, v2."""
    rng = np.random.RandomState(seed)
    v1 = (rng.rand(n1, h, w) + 0.5).astype(np.float32)
    v2 = (rng.rand(n2, h, w) + 0.5).astype(np.float32)
    k = (rng.rand(n1, n2, h, w) * np.sqrt(v1[:, None] * v2[None])).astype(np.float32)
    return k, v1, v2


def _scales():
    return torch.tensor([W * W, B * B], dtype=torch.float32)


# -- the lattice and the variance maps ----------------------------------------------

@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (6, 10), (5, 4), (1, 1)])
def test_stride2_stencil_on_the_lattice_is_the_strided_conv(hw):
    # S(.) read at the (oh, ow) lattice equals lax SAME's stride-2 conv.
    h, w = hw
    assert TRG._stride2_offsets(h, w) == JRG._stride2_offsets(h, w)
    (img,) = randn(1, (3, h, w))
    want = np.asarray(JL._patch_mean(jnp.asarray(img), (3, 3), (2, 2)))
    got = TRG._lattice(TCG._stencil(to_torch(img).reshape(3, h * w), h, w), h, w)
    np.testing.assert_allclose(to_numpy(got).reshape(want.shape), want, atol=2e-7)


@pytest.mark.parametrize("mismatch", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_tail_var_stack_matches_jax(act, mismatch):
    _, v, _ = _state(2, 4, 1, 7, 6)
    want_rows, want_v = JRG._tail_var_stack(jnp.asarray(v), 3, act, W, B, mismatch)
    got_rows, got_v = TRG.tail_var_stack(to_torch(v), 3, act, torch.tensor(W),
                                         torch.tensor(B), mismatch)
    assert got_rows.shape == (6, 4, 7, 6)
    _close(got_rows, want_rows)
    _close(got_v, want_v)


@pytest.mark.parametrize("hw", [(8, 8), (7, 7), (6, 10)])
@pytest.mark.parametrize("act", ACTS)
def test_strided_var_pieces_match_jax(act, hw):
    _, v, _ = _state(3, 4, 1, *hw)
    want = JRG._strided_var_pieces(jnp.asarray(v), act, W, B)
    got = TRG.strided_var_pieces(to_torch(v), act, torch.tensor(W), torch.tensor(B))
    for g, wv in zip(got, want):
        assert g.shape == wv.shape
        _close(g, wv)


# -- K5's plain version -----------------------------------------------------------------

TAIL_CASES = [("relu", (8, 8), 3, True), ("erf", (7, 7), 1, False),
              ("relu", (6, 10), 2, True), ("erf", (8, 8), 2, False)]


def _port_tail(k, v1, v2, act, nblocks, mismatch, h, w):
    tv1, tv2 = to_torch(v1, v2)
    s1, o1 = TRG.tail_var_stack(tv1, nblocks, act, torch.tensor(W), torch.tensor(B), mismatch)
    s2, o2 = TRG.tail_var_stack(tv2, nblocks, act, torch.tensor(W), torch.tensor(B), mismatch)
    n1, n2 = k.shape[:2]
    got = TRG.resnet_tail_plain(to_torch(k).reshape(n1, n2, h * w), TRG._flat(s1),
                                TRG._flat(s2), _scales(), nblocks=nblocks, act=act, h=h,
                                w=w, mismatch=mismatch)
    return got.reshape(k.shape), o1, o2


@pytest.mark.parametrize("act,hw,nblocks,mismatch", TAIL_CASES)
def test_resnet_tail_plain_matches_jax_interpret(act, hw, nblocks, mismatch):
    k, v1, v2 = _state(4, 6, 5, *hw)
    tail = jax.jit(lambda a, b, c: JRG.resnet_tail_blocks(
        a, b, c, nblocks=nblocks, act=act, w_std=W, b_std=B, mismatch=mismatch))
    want = tail(k, v1, v2)
    got = _port_tail(k, v1, v2, act, nblocks, mismatch, *hw)
    for g, wv in zip(got, want):
        _close(g, wv)


@pytest.mark.parametrize("act", ACTS)
def test_resnet_tail_plain_matches_jax_layer_tier(act):
    # The JAX layer tier's residual blocks (arch.get_conv_resnet_layer's
    # stride-1 group: a conv-shortcut block, then identity-shortcut blocks).
    k, v1, v2 = _state(5, 5, 4, 7, 6)

    def block(mismatch):
        main = JL.serial(jarch.get_act(act), JL.Conv(1, (3, 3), (1, 1), w_std=W, b_std=B),
                         jarch.get_act(act), JL.Conv(1, (3, 3), (1, 1), w_std=W, b_std=B))
        short = JL.Conv(1, (3, 3), (1, 1), w_std=W, b_std=B) if mismatch else JL.Identity()
        return JL.serial(JL.FanOut(2), JL.parallel(main, short), JL.FanInSum())

    layer = JL.serial(block(True), block(False), block(False))
    want = jax.jit(lambda a, b, c: layer.kfn(JS(nngp=a, var1=b, var2=c)))(k, v1, v2)
    got = _port_tail(k, v1, v2, act, 3, True, 7, 6)
    for g, wv in zip(got, (want.nngp, want.var1, want.var2)):
        _close(g, wv)


# -- K6's plain version -----------------------------------------------------------------

STRIDED_CASES = [("relu", (8, 8)), ("relu", (7, 7)), ("relu", (6, 10)), ("erf", (7, 7)),
                 ("erf", (6, 10))]


def _port_strided(k, v1, v2, act, h, w):
    tv1, tv2 = to_torch(v1, v2)
    wt, bt = torch.tensor(W), torch.tensor(B)
    m1, o1 = TRG.strided_var_pieces(tv1, act, wt, bt)
    m2, o2 = TRG.strided_var_pieces(tv2, act, wt, bt)
    n1, n2 = k.shape[:2]
    got = TRG.strided_block_plain(to_torch(k).reshape(n1, n2, h * w),
                                  (TRG._flat(tv1), TRG._flat(m1)),
                                  (TRG._flat(tv2), TRG._flat(m2)), _scales(), act=act, h=h,
                                  w=w)
    return got.reshape(n1, n2, *m1.shape[1:]), o1, o2


@pytest.mark.parametrize("act,hw", STRIDED_CASES)
def test_strided_block_plain_matches_jax_interpret(act, hw):
    # The TPU kernel runs at full resolution and XLA subsamples the lattice;
    # the plain version (and K6) computes the reduced state directly.
    k, v1, v2 = _state(6, 5, 4, *hw)
    block = jax.jit(lambda a, b, c: JRG.strided_mismatch_block(
        a, b, c, act=act, w_std=W, b_std=B, tile=(8, 8)))
    want = block(k, v1, v2)
    got = _port_strided(k, v1, v2, act, *hw)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape
        _close(g, wv)


@pytest.mark.parametrize("act,hw", STRIDED_CASES)
def test_strided_block_plain_matches_xla_mismatch_block(act, hw):
    k, v1, v2 = _state(7, 5, 4, *hw)
    want = jax.jit(lambda a, b, c: JRG._mismatch_block(a, b, c, (2, 2), act, W, B))(
        k, v1, v2)
    got = _port_strided(k, v1, v2, act, *hw)
    for g, wv in zip(got, want):
        _close(g, wv)


# -- the whole Gram ---------------------------------------------------------------------

GRAM_CASES = [("relu", (8, 8), 1), ("erf", (8, 8), 3), ("relu", (7, 7), 3),
              ("erf", (6, 10), 1)]


def _images(seed, hw, n1=6, n2=5, c=3):
    return randn(seed, (n1, *hw, c), (n2, *hw, c))


def _jax_value_and_vjp(f, g, *args):
    """f(*args) and its VJP on g, in one jitted call."""
    def run(g, *args):
        k, vjp = jax.vjp(f, *args)
        return k, vjp(g)

    k, grads = jax.jit(run)(jnp.asarray(g), *args)
    return np.asarray(k), [np.asarray(t) for t in grads]


@pytest.mark.parametrize("act,hw,depth", GRAM_CASES)
def test_conv_resnet_gram_matches_jax_layer_tier(act, hw, depth):
    x1, x2 = _images(8, hw)
    kfn = JL.kernel_fn_of(jarch.get_conv_resnet_layer(depth, 3, act, **SCALES))
    want = jax.jit(lambda a, b: kfn(a, b, get="nngp"))(x1, x2)
    got = TRG.conv_resnet_gram(*to_torch(x1, x2), depth=depth, num_class=3, act=act,
                               **SCALES)
    _close(got, want)


@pytest.mark.parametrize("act", ACTS)
def test_conv_resnet_layer_tier_matches_jax(act):
    x1, x2 = _images(9, (7, 6), n1=4, n2=3)
    kfn = JL.kernel_fn_of(jarch.get_conv_resnet_layer(2, 1, act, **SCALES))
    want = jax.jit(lambda a, b: kfn(a, b, get="nngp"))(x1, x2)
    got = TL.kernel_fn_of(tarch.get_conv_resnet_layer(2, 1, act, **SCALES))(
        *to_torch(x1, x2))
    _close(got, want)


def test_conv_resnet_gram_and_its_gradients_match_jax_interpret():
    # The JAX package's fused Gram (K5 / K6 interpreted; its custom VJP
    # recomputes through the layer tier) against _ConvResnetGram.
    x1, x2 = _images(10, (8, 8))
    (g,) = randn(11, (6, 5))

    def f(a, b, w, bs, last):
        return JRG.conv_resnet_gram(a, b, depth=2, act="relu", w_std=w, b_std=bs,
                                    last_w_std=last)

    want_k, want_g = _jax_value_and_vjp(f, g, x1, x2, W, B, LAST)
    leaves = [torch.tensor(v, requires_grad=True) for v in (x1, x2, W, B, LAST)]
    a, b, w, bs, last = leaves
    k = TRG.conv_resnet_gram(a, b, depth=2, act="relu", w_std=w, b_std=bs, last_w_std=last)
    _close(k, want_k)
    for got, want in zip(torch.autograd.grad(k, leaves, to_torch(g)), want_g):
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("panel", [None, 1, 9], ids=["one panel", "1x1", "3x3 ragged"])
@pytest.mark.parametrize("same", [False, True], ids=["x1,x2", "x,x"])
@pytest.mark.parametrize("act", ACTS)
def test_gradients_match_jax_reference_recursion(act, same, panel, monkeypatch):
    # x1, x2 and scale cotangents against jax.vjp of _reference_conv_resnet,
    # with the backward's recompute in one panel or in panels of 1 and of
    # at most 9 pairs (off-diagonal panels of K(x, x) take g[r, c] + g[c, r]^T).
    monkeypatch.setattr(TRG, "_PANEL_PAIRS", panel)
    x1, x2 = _images(12, (7, 6), n1=5, n2=4)
    x2 = x1 if same else x2
    (g,) = randn(13, (x1.shape[0], x2.shape[0]))

    def f(a, b, w, bs, last):
        return JRG._reference_conv_resnet(a, a if same else b, 2, 1, act, w, bs, last)

    _, want = _jax_value_and_vjp(f, g, x1, x2, W, B, LAST)
    leaves = [torch.tensor(v, requires_grad=True) for v in (x1, x2, W, B, LAST)]
    a, b, w, bs, last = leaves
    k = TRG.conv_resnet_gram(a, a if same else b, depth=2, act=act, w_std=w, b_std=bs,
                             last_w_std=last)
    wanted = [a, w, bs, last] if same else leaves
    before = TRG.RECOMPUTE["panels"]
    got = torch.autograd.grad(k, wanted, to_torch(g))
    assert TRG.RECOMPUTE["panels"] - before == {None: 1, 1: 15 if same else 20,
                                                9: 3 if same else 4}[panel]
    for gt, wt in zip(got, [want[0]] + want[2:] if same else want):
        np.testing.assert_allclose(to_numpy(gt), wt, rtol=1e-5,
                                   atol=1e-6 * np.abs(wt).max())


def test_frozen_inputs_give_zero_x_cotangents_and_the_same_scale_gradients():
    x1, x2 = _images(14, (6, 5), n1=4, n2=3)
    (g,) = randn(15, (4, 3))
    grads = {}
    for trainable in (True, False):
        leaves = [torch.tensor(v, requires_grad=True) for v in (x1, x2, W, B, LAST)]
        a, b, w, bs, last = leaves
        k = TRG.conv_resnet_gram(a, b, depth=2, act="relu", w_std=w, b_std=bs,
                                 last_w_std=last, trainable_inputs=trainable)
        grads[trainable] = torch.autograd.grad(k, leaves, to_torch(g))
    assert grads[True][0].abs().max() > 0
    assert not grads[False][0].any() and not grads[False][1].any()
    for want, got in zip(grads[True][2:], grads[False][2:]):
        assert torch.equal(want, got)


# -- the kernel function and the wrappers ---------------------------------------------

@pytest.mark.parametrize("act", ACTS)
def test_get_conv_resnet_kernel_matches_jax(act):
    # JAX's kernel_fn takes its layer tier on the CPU; the port's goes to
    # the fused Gram's plain versions. x2=None means K(x, x).
    (x,) = randn(16, (5, 8, 8, 2))
    jfn = jarch.get_conv_resnet_kernel(2, 1, act, **SCALES)
    want = jax.jit(lambda a: jfn(a, None, get="nngp"))(x)
    got = to_numpy(tarch.get_conv_resnet_kernel(2, 1, act, **SCALES)(to_torch(x), None))
    _close(got, want)
    np.testing.assert_allclose(got, got.T, atol=1e-7)


def test_get_conv_resnet_kernel_routes_by_image_size(monkeypatch):
    # h w <= 1024 goes to conv_resnet_gram; larger images take the layer tier.
    calls = []
    real = TRG.conv_resnet_gram
    monkeypatch.setattr(TRG, "conv_resnet_gram",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kfn = tarch.get_conv_resnet_kernel(1, 1, "relu", **SCALES)
    small, big = randn(17, (2, 32, 32, 1), (2, 33, 32, 1))
    kfn(to_torch(small))
    assert len(calls) == 1
    got = kfn(to_torch(big))
    assert len(calls) == 1
    want = TL.kernel_fn_of(tarch.get_conv_resnet_layer(1, 1, "relu", **SCALES))(
        to_torch(big))
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), atol=1e-6)
    assert tarch.KERNELS["resnet-conv"] is tarch.get_conv_resnet_kernel


# (h, w) -> K6's streamed geometry: (lanes, rows, lg, rstride, cstride) of the
# full-resolution state (stream_geometry's), then the reduced state's
# (ors, ocs). The WideResNet's group boundaries, odd and rectangular states,
# and states wider than 32 (transposed: the reduced strides swap too).
STRIDED_GEOMETRY = {(32, 32): (32, 32, 5, 32, 1, 16, 1), (16, 16): (16, 16, 4, 16, 1, 8, 1),
                    (8, 8): (8, 8, 3, 8, 1, 4, 1), (7, 7): (7, 7, 3, 7, 1, 4, 1),
                    (6, 10): (10, 6, 4, 10, 1, 5, 1), (1, 1): (1, 1, 0, 1, 1, 1, 1),
                    (5, 64): (5, 64, 3, 1, 64, 1, 32), (3, 48): (3, 48, 2, 1, 48, 1, 24),
                    (1, 1024): (1, 1024, 0, 1, 1024, 1, 512), (1024, 1): (1, 1024, 0, 1, 1, 1, 1),
                    (9, 33): (9, 33, 4, 1, 33, 1, 17)}


@pytest.mark.parametrize("hw", list(STRIDED_GEOMETRY),
                         ids=[f"{h}x{w}" for h, w in STRIDED_GEOMETRY])
def test_strided_geometry_maps_the_lattice(hw):
    # Reduced element (a, b) of the stream, at pixel a * ors + b * ocs of
    # the reduced state, comes from full-resolution element (2a + oR, 2b +
    # oC) of the stream, the offsets taken from the parity of the streamed
    # extents as the kernel takes them: that element is the lattice point
    # (2a' + oh, 2b' + ow) of reduced pixel (a', b'). Each reduced pixel once.
    h, w = hw
    lanes, rows, lg, rs, cs, ors, ocs = TRG.strided_geometry(h, w)
    assert (lanes, rows, lg, rs, cs, ors, ocs) == STRIDED_GEOMETRY[hw]
    assert (lanes, rows, lg, rs, cs) == TRG.stream_geometry(h, w)
    oh, ow = TRG._stride2_offsets(h, w)
    o_r, o_c = 1 - rows % 2, 1 - lanes % 2
    wr = -(-w // 2)
    seen = []
    for a in range(-(-rows // 2)):
        for b in range(-(-lanes // 2)):
            q = a * ors + b * ocs
            p = (2 * a + o_r) * rs + (2 * b + o_c) * cs
            assert divmod(p, w) == (2 * (q // wr) + oh, 2 * (q % wr) + ow)
            seen.append(q)
    assert sorted(seen) == list(range(-(-h // 2) * wr))


@pytest.mark.parametrize("nblocks", range(1, 10))
@pytest.mark.parametrize("mismatch", [True, False])
def test_tail_chunks_chain_the_blocks(nblocks, mismatch):
    # At most four blocks a K5 launch (the kernel's limit), in order, the
    # conv shortcut in the first launch only; SVSP's depth 4 (group 1) and 3
    # (groups 2-4) take one.
    chunks = TRG.tail_chunks(nblocks, mismatch, 4)
    assert [b for first, count, _ in chunks for b in range(first, first + count)] == \
        list(range(nblocks))
    assert all(1 <= count <= 4 for _, count, _ in chunks)
    assert [sc for _, _, sc in chunks] == [mismatch] + [False] * (len(chunks) - 1)
    assert len(chunks) == (1 if nblocks <= 4 else -(-nblocks // 4))


def _transposed_rows(z, h, w):
    """[..., H W] -> [..., W H]: the state of the transposed images."""
    return z.reshape(z.shape[:-1] + (h, w)).transpose(-1, -2).reshape(z.shape).contiguous()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("hw", [(9, 7), (5, 40), (3, 48), (1, 33)],
                         ids=["9x7", "5x40", "3x48", "1x33"])
def test_resnet_tail_plain_is_unchanged_by_transposing_the_state(hw, act):
    # The identity the wide-image launch rests on: the 3 x 3 SAME mean
    # commutes with transposition, only its sums' order changes (1e-6 of
    # max|K|).
    h, w = hw
    k, v1, v2 = _state(23, 4, 3, h, w)
    tv1, tv2 = to_torch(v1, v2)
    s1, _ = TRG.tail_var_stack(tv1, 2, act, torch.tensor(W), torch.tensor(B), True)
    s2, _ = TRG.tail_var_stack(tv2, 2, act, torch.tensor(W), torch.tensor(B), True)
    args = (to_torch(k).reshape(4, 3, h * w), TRG._flat(s1), TRG._flat(s2))
    kw = dict(nblocks=2, act=act, mismatch=True)
    want = TRG.resnet_tail_plain(*args, _scales(), h=h, w=w, **kw)
    got = TRG.resnet_tail_plain(*(_transposed_rows(z, h, w) for z in args), _scales(), h=w,
                                w=h, **kw)
    assert (_transposed_rows(got, w, h) - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("hw", [(9, 7), (6, 10), (5, 40), (4, 64), (1, 33)],
                         ids=["9x7", "6x10", "5x40", "4x64", "1x33"])
def test_strided_block_plain_is_unchanged_by_transposing_the_state(hw, act):
    # The identity K6's transposed launch rests on: the block on the
    # transposed state (its lattice offsets (oh, ow) swapped, as they follow
    # the extents' parity) is the transposed block, only the stencils' sums
    # reordered (1e-6 of max|K|).
    h, w = hw
    hr, wr = -(-h // 2), -(-w // 2)
    k, v1, v2 = _state(30, 4, 3, h, w)
    tv1, tv2 = to_torch(v1, v2)
    wt, bt = torch.tensor(W), torch.tensor(B)
    m1, _ = TRG.strided_var_pieces(tv1, act, wt, bt)
    m2, _ = TRG.strided_var_pieces(tv2, act, wt, bt)
    kt = to_torch(k).reshape(4, 3, h * w)
    rows1 = (TRG._flat(tv1), TRG._flat(m1))
    rows2 = (TRG._flat(tv2), TRG._flat(m2))
    want = TRG.strided_block_plain(kt, rows1, rows2, _scales(), act=act, h=h, w=w)

    def flip(rows):
        return _transposed_rows(rows[0], h, w), _transposed_rows(rows[1], hr, wr)

    got = TRG.strided_block_plain(_transposed_rows(kt, h, w), flip(rows1), flip(rows2),
                                  _scales(), act=act, h=w, w=h)
    assert (_transposed_rows(got, wr, hr) - want).abs().max() <= 1e-6 * want.abs().max()


def test_resnet_tail_cuda_refuses_same_for_two_operands():
    """same=True mirrors the lower triangle, so the wrapper takes it only
    for K(x, x)'s state with v2s v1s."""
    k, _, _ = _state(24, 3, 3, 4, 4)
    kt = to_torch(k).reshape(3, 3, 16)
    rows = torch.ones(2, 3, 16)
    with pytest.raises(ValueError, match="same=True.*v2 is not v1"):
        TRG.resnet_tail_cuda(kt, rows, rows.clone(), _scales(), nblocks=1, act="relu", h=4,
                             w=4, same=True)
    with pytest.raises(ValueError, match="same=True"):
        TRG.resnet_tail_cuda(kt[:, :2].contiguous(), rows, rows, _scales(), nblocks=1,
                             act="relu", h=4, w=4, same=True)


@pytest.mark.parametrize("other", ["v_in", "v_mid", "k"])
def test_strided_cuda_refuses_same_for_two_operands(other):
    """K6's same=True mirrors the lower triangle, so the wrapper takes it
    only for K(x, x)'s square state with v2s v1s."""
    k, _, _ = _state(31, 3, 3, 4, 4)
    kt = to_torch(k).reshape(3, 3, 16)
    v_in, v_mid = torch.ones(3, 16), torch.ones(3, 4)
    rows2 = dict(v_in=(v_in.clone(), v_mid), v_mid=(v_in, v_mid.clone()),
                 k=(v_in, v_mid))[other]
    if other == "k":
        kt = kt[:, :2].contiguous()
    with pytest.raises(ValueError, match="same=True" + ("" if other == "k"
                                                        else f".*{other}2 is not {other}1")):
        TRG.strided_cuda(kt, (v_in, v_mid), rows2, _scales(), act="relu", h=4, w=4, same=True)


def test_cuda_wrappers_reject_cpu_tensors_and_count_no_launch():
    x1, x2 = _images(18, (8, 8))
    before = dict(TRG.LAUNCHES)
    TRG.conv_resnet_gram(*to_torch(x1, x2), depth=2, **SCALES)
    assert TRG.LAUNCHES == before              # CPU tensors never reach a kernel
    k, v1, v2 = (to_torch(a) for a in _state(19, 3, 2, 4, 4))
    rows = torch.ones(2, 3, 16)
    with pytest.raises(ValueError, match="CUDA"):
        TRG.resnet_tail_cuda(k.reshape(3, 2, 16), rows, rows[:, :2], _scales(), nblocks=1,
                             act="relu", h=4, w=4)
    with pytest.raises(ValueError, match="CUDA"):
        TRG.strided_cuda(k.reshape(3, 2, 16), (rows[0], rows[0, :, :4]),
                         (rows[0, :2], rows[0, :2, :4]), _scales(), act="relu", h=4, w=4)
    with pytest.raises(KeyError):
        TRG.conv_resnet_gram(*to_torch(x1, x2), depth=2, act="tanh", **SCALES)
    with pytest.raises(ValueError, match="depth"):
        TRG.conv_resnet_gram(*to_torch(x1, x2), depth=0, **SCALES)


@pytest.mark.parametrize("act", ACTS)
def test_cuda_kernels_match_plain_versions(cuda_device, act):
    # K5 and K6 within 1e-5 of max|K| of their plain versions, the bench.py
    # bar, ragged 9 x 7 images. Runs only on a CUDA card.
    k, v1, v2 = _state(20, 37, 21, 9, 7)
    with torch.inference_mode():
        kt, tv1, tv2 = (t.to(cuda_device) for t in to_torch(k, v1, v2))
        wt, bt = (torch.tensor(v, device=cuda_device) for v in (W, B))
        scales = torch.stack([wt * wt, bt * bt])
        s1, _ = TRG.tail_var_stack(tv1, 2, act, wt, bt, True)
        s2, _ = TRG.tail_var_stack(tv2, 2, act, wt, bt, True)
        args = (kt.reshape(37, 21, 63), TRG._flat(s1), TRG._flat(s2),
                scales)
        kw = dict(nblocks=2, act=act, h=9, w=7, mismatch=True)
        got, want = TRG.resnet_tail_cuda(*args, **kw), TRG.resnet_tail_plain(*args, **kw)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        m1, _ = TRG.strided_var_pieces(tv1, act, wt, bt)
        m2, _ = TRG.strided_var_pieces(tv2, act, wt, bt)
        args = (kt.reshape(37, 21, 63), (TRG._flat(tv1), TRG._flat(m1)),
                (TRG._flat(tv2), TRG._flat(m2)), scales)
        got = TRG.strided_cuda(*args, act=act, h=9, w=7)
        want = TRG.strided_block_plain(*args, act=act, h=9, w=7)
        assert got.shape == (37, 21, 20)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# (h, w, nblocks, mismatch): the widths of the WideResNet's groups and of
# narrow states (4, 7, 8, 16, 28), an image wider than 32 (transposed), and
# a tail of five blocks, chained over two launches.
STREAMED_CASES = [(4, 4, 3, False), (7, 7, 2, True), (8, 8, 3, False), (16, 16, 3, False),
                  (28, 28, 4, True), (5, 40, 2, True), (6, 10, 5, True)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("h,w,nblocks,mismatch", STREAMED_CASES,
                         ids=[f"{h}x{w}-{n}{'+sc' if m else ''}"
                              for h, w, n, m in STREAMED_CASES])
def test_cuda_streamed_k5_is_symmetric_repeatable_and_matches_plain(cuda_device, act, h, w,
                                                                    nblocks, mismatch):
    # K5 within 1e-5 of max|K| of its plain version on a cross state and on
    # K(x, x)'s (same=True), a symmetric launch bitwise symmetric, a second
    # launch bitwise equal. Runs only on a CUDA card.
    x1, x2 = _images(25, (h, w), n1=17, n2=9)
    with torch.inference_mode():
        a, b = (t.to(cuda_device) for t in to_torch(x1, x2))
        wt, bt = (torch.tensor(v, device=cuda_device) for v in (W, B))
        scales = torch.stack([wt * wt, bt * bt])
        kw = dict(nblocks=nblocks, act=act, h=h, w=w, mismatch=mismatch)
        for x, y, same in ((a, b, False), (a, a, True)):
            k, v1, v2 = TRG._front(x, y, wt * wt, bt * bt, same)
            s1, _ = TRG.tail_var_stack(v1, nblocks, act, wt, bt, mismatch)
            s2 = s1 if same else TRG.tail_var_stack(v2, nblocks, act, wt, bt, mismatch)[0]
            args = (k.reshape(k.shape[0], k.shape[1], h * w).contiguous(), TRG._flat(s1),
                    TRG._flat(s2), scales)
            got = TRG.resnet_tail_cuda(*args, **kw, same=same)
            again = TRG.resnet_tail_cuda(*args, **kw, same=same)
            want = TRG.resnet_tail_plain(*args, **kw)
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()
            assert torch.equal(got, again)
            if same:
                assert torch.equal(got, got.transpose(0, 1))


# (h, w): the WideResNet's group boundaries (32, 16, 8), odd and rectangular
# states, a state wider than 32 (transposed) and a one-pixel one.
K6_CASES = [(32, 32), (8, 8), (7, 7), (6, 10), (5, 64), (3, 40), (1, 1)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("h,w", K6_CASES, ids=[f"{h}x{w}" for h, w in K6_CASES])
def test_cuda_streamed_k6_is_symmetric_repeatable_and_matches_plain(cuda_device, act, h, w):
    # K6 within 1e-5 of max|K| of its plain version on a cross state and on
    # K(x, x)'s (same=True), a symmetric launch bitwise symmetric, a second
    # launch bitwise equal. Runs only on a CUDA card.
    x1, x2 = _images(32, (h, w), n1=17, n2=9)
    with torch.inference_mode():
        a, b = (t.to(cuda_device) for t in to_torch(x1, x2))
        wt, bt = (torch.tensor(v, device=cuda_device) for v in (W, B))
        scales = torch.stack([wt * wt, bt * bt])
        for x, y, same in ((a, b, False), (a, a, True)):
            k, v1, v2 = TRG._front(x, y, wt * wt, bt * bt, same)
            m1, _ = TRG.strided_var_pieces(v1, act, wt, bt)
            m2 = m1 if same else TRG.strided_var_pieces(v2, act, wt, bt)[0]
            rows1 = (TRG._flat(v1), TRG._flat(m1))
            rows2 = rows1 if same else (TRG._flat(v2), TRG._flat(m2))
            args = (k.reshape(k.shape[0], k.shape[1], h * w).contiguous(), rows1, rows2,
                    scales)
            got = TRG.strided_cuda(*args, act=act, h=h, w=w, same=same)
            again = TRG.strided_cuda(*args, act=act, h=h, w=w, same=same)
            want = TRG.strided_block_plain(*args, act=act, h=h, w=w)
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()
            assert torch.equal(got, again)
            if same:
                assert torch.equal(got, got.transpose(0, 1))


def test_cuda_symmetric_strided_decodes_pair_indices_past_an_int(cuda_device):
    # A symmetric K6 launch over the one-pixel states of n = 65,536 images:
    # its n (n + 1) / 2 pairs number more than 2^31 (tri_pair in
    # csrc/stream.cuh). It reads one 17 GB state and writes another. Rows at
    # both ends and the middle within 1e-5 of max|K| of the plain version on
    # those rows; the whole result bitwise symmetric. Runs only on a CUDA
    # card.
    n = 65_536
    assert n * (n + 1) // 2 > 2**31
    (x,) = randn(33, (2, n))
    with torch.inference_mode():
        a = to_torch(x).to(cuda_device)
        k = torch.outer(a[0], a[0])             # the input moment of 2 channels,
        k.add_(torch.outer(a[1], a[1])).mul_(0.5)   # bitwise symmetric
        wt, bt = (torch.tensor(v, device=cuda_device) for v in (W, B))
        v0 = (0.5 * (a * a).sum(dim=0)).reshape(n, 1, 1)
        m0, _ = TRG.strided_var_pieces(v0, "relu", wt, bt)
        rows_v = (TRG._flat(v0), TRG._flat(m0))
        scales = torch.stack([wt * wt, bt * bt])
        got = TRG.strided_cuda(k.reshape(n, n, 1), rows_v, rows_v, scales, act="relu", h=1,
                               w=1, same=True).reshape(n, n)
        del k
        rows = torch.tensor([0, 1, n // 2, n - 2, n - 1], device=cuda_device)
        k_rows = 0.5 * (torch.outer(a[0, rows], a[0]) + torch.outer(a[1, rows], a[1]))
        want = TRG.strided_block_plain(k_rows.reshape(5, n, 1),
                                       (rows_v[0][rows], rows_v[1][rows]), rows_v, scales,
                                       act="relu", h=1, w=1).reshape(5, n)
        assert (got[rows] - want).abs().max() <= 1e-5 * want.abs().max()
        for r in range(0, n, 4096):
            assert torch.equal(got[r:r + 4096], got[:, r:r + 4096].T)


def test_cuda_symmetric_tail_decodes_pair_indices_past_an_int(cuda_device):
    # A symmetric K5 launch (one block with the conv shortcut) over the
    # one-pixel states of n = 65,536 images: its n (n + 1) / 2 pairs number
    # more than 2^31, so the last rows' pairs decode from indices past an
    # int (tri_pair in csrc/stream.cuh). Rows at both ends and the middle
    # within 1e-5 of max|K| of the plain version on those rows; the whole
    # state (17 GB) bitwise symmetric. Runs only on a CUDA card.
    n = 65_536
    assert n * (n + 1) // 2 > 2**31
    (x,) = randn(27, (2, n))
    with torch.inference_mode():
        a = to_torch(x).to(cuda_device)
        k = torch.outer(a[0], a[0])             # the input moment of 2 channels,
        k.add_(torch.outer(a[1], a[1])).mul_(0.5)   # bitwise symmetric
        wt, bt = (torch.tensor(v, device=cuda_device) for v in (W, B))
        v0 = (0.5 * (a * a).sum(dim=0)).reshape(n, 1, 1)
        rows_v = TRG._flat(TRG.tail_var_stack(v0, 1, "relu", wt, bt, True)[0])
        scales = torch.stack([wt * wt, bt * bt])
        kw = dict(nblocks=1, act="relu", h=1, w=1, mismatch=True)
        got = TRG.resnet_tail_cuda(k.reshape(n, n, 1), rows_v, rows_v, scales, **kw,
                                   same=True).reshape(n, n)
        rows = torch.tensor([0, 1, n // 2, n - 2, n - 1], device=cuda_device)
        want = TRG.resnet_tail_plain(k[rows].reshape(5, n, 1), rows_v[:, rows], rows_v,
                                     scales, **kw).reshape(5, n)
        assert (got[rows] - want).abs().max() <= 1e-5 * want.abs().max()
        for r in range(0, n, 4096):
            assert torch.equal(got[r:r + 4096], got[:, r:r + 4096].T)
