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

import numpy as np
import pytest
import torch

import snngp.ops.pallas.gram as G
from snngp.nn import arch as jarch
from snngp.nn.layers import kernel_fn_of as jkernel_fn_of

from snngp_torch.nn import arch as tarch
from snngp_torch.ops import gram as TG

from _torch_parity import cuda_device, randn, to_numpy, to_torch  # noqa: F401

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
