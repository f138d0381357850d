"""Port parity: the fused NNGP Gram (snngp_torch/ops/gram.py, K1) against the
JAX package's Pallas kernel (interpreter mode on the CPU) and its reference
layer tier.

On a CPU tensor the port's mlp_gram / resnet_gram run the plain PyTorch
version of the CUDA kernel, so these tests pin the math the kernel must
match; the kernel itself is held to that plain version on the card by
chip_smoke.py (and by the CUDA test at the end where a card is present).

Tolerances: atol 2e-6 (mlp) and 5e-6 (resnet) are the JAX package's own
Pallas-vs-reference bars (tests/test_pallas.py:27,72): fp32 round-off of
a depth-3 recursion whose resnet Gram grows to ~10 in magnitude. Against the
Pallas kernel add the <= 5e-7 error of its polynomial arccos
(tests/test_pallas.py:61), which the port replaces by torch.acos.
"""

import math

import numpy as np
import pytest
import torch

import snngp.ops.pallas.gram as G
from snngp.nn import arch as jarch
from snngp.nn.layers import kernel_fn_of as jkernel_fn_of

from snngp_torch.nn import arch as tarch
from snngp_torch.ops import gram as TG

from _torch_parity import cuda_device, dual_act_inputs, randn, to_numpy, to_torch  # noqa: F401

SCALES = dict(w_std=1.3, b_std=0.3, last_w_std=0.9)
ATOL = {"mlp": 2e-6, "resnet": 5e-6}
POLY_ACOS = 5e-7


@pytest.fixture(autouse=True)
def _interpret_mode():
    G.INTERPRET = True
    yield
    G.INTERPRET = False


def _jax_gram(mode):
    return G.mlp_gram if mode == "mlp" else G.resnet_gram


def _torch_gram(mode):
    return TG.mlp_gram if mode == "mlp" else TG.resnet_gram


def _jax_layer(mode):
    return jarch.get_mlp_layer if mode == "mlp" else jarch.get_dense_resnet_layer


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_gram_matches_pallas_kernel_symmetric(mode, act):
    (x,) = randn(0, (260, 9))
    want = np.asarray(_jax_gram(mode)(x, x, depth=3, act=act, tile=(128, 128), **SCALES))
    xt = to_torch(x)
    got = to_numpy(_torch_gram(mode)(xt, xt, depth=3, act=act, **SCALES))
    np.testing.assert_allclose(got, want, atol=ATOL[mode] + POLY_ACOS)


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_gram_matches_pallas_kernel_cross_shape(mode, act):
    # 200 x 7 vs 150 x 7: ragged against the Pallas 128-row tiles and
    # 128-lane feature padding, which the port does not have.
    x1, x2 = randn(1, (200, 7), (150, 7))
    want = np.asarray(_jax_gram(mode)(x1, x2, depth=3, act=act, tile=(128, 128), **SCALES))
    got = to_numpy(_torch_gram(mode)(*to_torch(x1, x2), depth=3, act=act, **SCALES))
    np.testing.assert_allclose(got, want, atol=ATOL[mode] + POLY_ACOS)


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_gram_matches_reference_tier(mode, act):
    x1, x2 = randn(2, (120, 5), (90, 5))
    want = np.asarray(jkernel_fn_of(_jax_layer(mode)(3, 1, act, 1.3, 0.3, 0.9))(
        x1, x2, get="nngp"))
    got = to_numpy(_torch_gram(mode)(*to_torch(x1, x2), depth=3, act=act, **SCALES))
    np.testing.assert_allclose(got, want, atol=ATOL[mode])


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_var_stacks_match(mode, act):
    # rtol 1e-6: an O(depth) scalar recursion per row, fp32 round-off only.
    (x,) = randn(3, (50, 6))
    jfn = G.mlp_var_stack if mode == "mlp" else G.resnet_var_stack
    tfn = TG.mlp_var_stack if mode == "mlp" else TG.resnet_var_stack
    want = np.asarray(jfn(x, 4, act, 1.2, 0.4))
    got = to_numpy(tfn(to_torch(x), 4, act, torch.tensor(1.2), torch.tensor(0.4)))
    assert got.shape == (5, 50)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_arch_kernel_fn_matches_jax(mode):
    # The architectures' kernel_fn routes 2-D NNGP blocks to the fused Gram;
    # x2=None means K(x, x).
    (x,) = randn(4, (70, 4))
    jget = jarch.get_mlp_kernel if mode == "mlp" else jarch.get_dense_resnet_kernel
    tget = tarch.get_mlp_kernel if mode == "mlp" else tarch.get_dense_resnet_kernel
    want = np.asarray(jget(2, act="relu", **SCALES)(x, None, get="nngp"))
    got = to_numpy(tget(2, act="relu", **SCALES)(to_torch(x), None, get="nngp"))
    np.testing.assert_allclose(got, want, atol=ATOL[mode])


def test_plain_version_on_kernel_inputs_is_symmetric_and_counts_no_launch():
    (x,) = randn(5, (64, 3))
    xt = to_torch(x)
    before = dict(TG.LAUNCHES)
    k = TG.mlp_gram(xt, xt, depth=2, act="relu", **SCALES)
    assert TG.LAUNCHES == before  # CPU tensors never reach the kernel
    np.testing.assert_allclose(to_numpy(k), to_numpy(k.T), atol=1e-7)


@pytest.mark.parametrize("act", ["relu", "erf"])
def test_per_row_factor_duals_match_jax(act):
    """K1's per-row factor form of the dual activations, written out here as
    csrc/gram.cu computes it (relu a = sqrt(max(v, 1e-30)), r = 1 / a,
    c = k (r_i r_j), s = a_i a_j; erf e = 1 / sqrt(1 + 2 v), c = 2 k
    (e_i e_j); sin(theta) by rsqrt), against the JAX package's _relu_t /
    _erf_t in fp32: within 1e-6 of max|T| (the JAX arccos polynomial is
    within 2e-8)."""
    k, v1, v2 = dual_act_inputs(act, 40)
    kt, v1t, v2t = to_torch(k, v1, v2)
    if act == "relu":
        a1, a2 = (torch.sqrt(torch.clamp(v, min=1e-30)) for v in (v1t, v2t))
        c = torch.clamp(kt * ((1.0 / a1) * (1.0 / a2)), -1.0, 1.0)
        s2 = torch.clamp(1.0 - c * c, min=0.0)
        sin_t = torch.where(s2 > 0.0, s2 * torch.rsqrt(s2), 0.0)
        got = (a1 * a2 * sin_t + (math.pi - torch.acos(c)) * kt) * (0.5 / math.pi)
        want = np.asarray(G._relu_t(k, v1, v2))
    else:
        e1, e2 = (1.0 / torch.sqrt(1.0 + 2.0 * v) for v in (v1t, v2t))
        got = (2.0 / math.pi) * torch.asin(torch.clamp(2.0 * kt * (e1 * e2), -1.0, 1.0))
        want = np.asarray(G._erf_t(k, v1, v2))
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("other", ["x", "v"])
def test_gram_cuda_refuses_same_for_two_operands(other):
    """same=True mirrors the lower triangle, so the wrapper takes it only
    when x2 and v2s are x1's and v1s (checked before the device)."""
    (x,) = randn(8, (8, 3))
    a = to_torch(x)
    v = TG.mlp_var_stack(a, 2, "relu", 1.0, 0.1)
    ops = dict(x=(a, a), v=(v, v))
    ops[other] = (ops[other][0], ops[other][0].clone())
    with pytest.raises(ValueError, match=f"same=True.*{other}2 is not {other}1"):
        TG.gram_cuda(*ops["x"], *ops["v"], torch.ones(4), depth=2, act="relu", mode="mlp",
                     same=True)


def test_cuda_wrapper_rejects_cpu_tensors():
    (x,) = randn(6, (8, 3))
    xt = to_torch(x)
    v = TG.mlp_var_stack(xt, 2, "relu", 1.0, 0.1)
    scales = torch.tensor([1.0, 0.01, 1.0, 1.0 / 3])
    with pytest.raises(ValueError, match="CUDA"):
        TG.gram_cuda(xt, xt, v, v, scales, depth=2, act="relu", mode="mlp")
    with pytest.raises(KeyError):
        TG.mlp_gram(xt, xt, depth=2, act="tanh", **SCALES)


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_cuda_kernel_matches_plain_version(cuda_device, mode, act):
    # The bench.py bar: relative error <= 1e-5 against the plain version on
    # the same inputs. Runs only where a CUDA card is present.
    x1, x2 = randn(7, (301, 11), (77, 11))
    with torch.inference_mode():
        a, b = to_torch(x1, x2)
        a, b = a.to(cuda_device), b.to(cuda_device)
        got = _torch_gram(mode)(a, b, depth=4, act=act, **SCALES)
        stack = TG.mlp_var_stack if mode == "mlp" else TG.resnet_var_stack
        w, bs, last = (torch.tensor(v, device=cuda_device) for v in (1.3, 0.3, 0.9))
        scales = torch.stack([w * w, bs * bs, last * last,
                              torch.tensor(1.0 / 11, device=cuda_device)])
        want = TG.gram_plain(a, b, stack(a, 4, act, w, bs), stack(b, 4, act, w, bs),
                             scales, depth=4, act=act, mode=mode)
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= 1e-5


def _cuda_gram_inputs(x, depth, act, mode, b_std=0.3):
    stack = TG.mlp_var_stack if mode == "mlp" else TG.resnet_var_stack
    w, b, last = (torch.tensor(v, device=x.device) for v in (1.3, b_std, 0.9))
    scales = torch.stack([w * w, b * b, last * last,
                          torch.tensor(1.0 / x.shape[1], device=x.device)])
    return stack(x, depth, act, w, b).contiguous(), scales


@pytest.mark.parametrize("n", [1, 63, 64, 65, 301])
@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_cuda_symmetric_gram_is_bitwise_symmetric_repeatable_and_matches_plain(
        cuda_device, mode, act, n):
    # K(x, x) by the symmetric launch (the lower-triangle tiles, mirrored):
    # ragged against the 64 x 64 tiles, one tile, a diagonal tile alone.
    (x,) = randn(30 + n, (n, 11))
    with torch.inference_mode():
        a = to_torch(x).to(cuda_device)
        v, scales = _cuda_gram_inputs(a, 4, act, mode)
        kw = dict(depth=4, act=act, mode=mode)
        got = TG.gram_cuda(a, a, v, v, scales, **kw, same=True)
        again = TG.gram_cuda(a, a, v, v, scales, **kw, same=True)
        want = TG.gram_plain(a, a, v, v, scales, **kw)
    assert torch.equal(got, again) and torch.equal(got, got.T)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("case", ["deep cross", "deep symmetric", "zero row symmetric",
                                  "zero row cross"])
@pytest.mark.parametrize("mode", ["mlp", "resnet"])
def test_cuda_gram_deep_and_zero_variance_rows_match_plain(cuda_device, mode, case):
    # Depth 20 stages the row factors in three passes of 8 layers; a row of
    # zeros with b_std = 0 has zero variance at every layer (the relu
    # factors' floor) against rows of variance up to ~1e4.
    x1, x2 = randn(33, (130, 6), (70, 6))
    depth = 20 if case.startswith("deep") else 4
    b_std = 0.0 if case.startswith("zero") else 0.3
    if case.startswith("zero"):
        x1[5] = 0.0
        x1[7] *= 100.0
    with torch.inference_mode():
        a, b = (t.to(cuda_device) for t in to_torch(x1, x2))
        if case.endswith("symmetric"):
            b = a
        va, scales = _cuda_gram_inputs(a, depth, "relu", mode, b_std)
        vb = va if b is a else _cuda_gram_inputs(b, depth, "relu", mode, b_std)[0]
        kw = dict(depth=depth, act="relu", mode=mode)
        got = TG.gram_cuda(a, b, va, vb, scales, **kw, same=b is a)
        want = TG.gram_plain(a, b, va, vb, scales, **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_cuda_gram_route_launches_the_symmetric_kernels(cuda_device):
    # kernel_fn(x, None) and the scalar-tangent backward of K(x, x) reach
    # K1 and K2 with same=True: K(x, x) comes out bitwise symmetric.
    (x,) = randn(34, (150, 5))
    a = to_torch(x).to(cuda_device)
    w, b, last = (torch.tensor(v, device=cuda_device, requires_grad=True)
                  for v in (1.3, 0.3, 0.9))
    before = dict(TG.LAUNCHES)
    k = tarch.get_mlp_kernel(3, act="relu", w_std=w, b_std=b, last_w_std=last,
                             trainable_inputs=False)(a, None, get="nngp")
    k.sum().backward()
    assert torch.equal(k, k.T)
    assert TG.LAUNCHES["gram"] == before["gram"] + 1
    assert TG.LAUNCHES["gram_grads"] == before["gram_grads"] + 1
    assert all(torch.isfinite(t.grad) for t in (w, b, last))
