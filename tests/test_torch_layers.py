"""Port parity: the dense NNGP layer tier (snngp_torch/nn/layers.py,
state.py, arch.py builders) against snngp.nn.layers on the same inputs.

Tolerance: atol 2e-6 for the MLP recursions and 5e-6 for the dense ResNet
(whose Gram grows to ~10), the JAX package's own fp32 bars for this
recursion (tests/test_pallas.py:27,72); the two frameworks' matmul and
acos/asin differ in the last bits only.
"""

import numpy as np
import pytest
import torch

from snngp.nn import arch as jarch
from snngp.nn import layers as JL
from snngp.nn.state import input_state as j_input_state

from snngp_torch.nn import arch as tarch
from snngp_torch.nn import layers as TL
from snngp_torch.nn.state import input_state as t_input_state

from _torch_parity import assert_fp32_reach, randn, to_numpy, to_torch


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("depth", [1, 3])
def test_mlp_layer_kernel_matches(depth, act):
    x1, x2 = randn(10, (40, 6), (25, 6))
    want = JL.kernel_fn_of(jarch.get_mlp_layer(depth, 1, act, 1.4, 0.2, 0.8))(x1, x2, get="nngp")
    got = TL.kernel_fn_of(tarch.get_mlp_layer(depth, 1, act, 1.4, 0.2, 0.8))(*to_torch(x1, x2))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("depth", [1, 3])
def test_dense_resnet_layer_kernel_matches(depth, act):
    (x,) = randn(11, (40, 6))
    want = JL.kernel_fn_of(jarch.get_dense_resnet_layer(depth, 1, act, 1.1, 0.3, 0.9))(
        x, None, get="nngp")
    got = TL.kernel_fn_of(tarch.get_dense_resnet_layer(depth, 1, act, 1.1, 0.3, 0.9))(
        to_torch(x), None)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=5e-6)


# Ceilings of assert_fp32_reach on the layer-0 state: each package's fp32
# error against float64, relative to the field's largest entry, within 4x
# the largest error either package showed on MKL's COMPATIBLE, SSE4_2, AVX,
# AVX2 and AVX512 code paths and on AVX512 with one thread (beside each).
INPUT_STATE_REACH = {"nngp": 2e-7,    # largest 5.39e-8: both packages
                     "var1": 1.2e-7,  # largest 3.02e-8: both packages
                     "var2": 3e-7}    # largest 8.04e-8: both packages


def _tf32(x):
    """``x`` rounded to TF32's 10 fraction bits (round half up)."""
    bits = torch.as_tensor(x).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_input_state_matches():
    # rtol 1e-6 plus atol 1e-6 of max|K| between the packages, as this file's
    # other bars: an entry that nearly cancels (|K| ~ 3e-4 of max|K|) differs
    # between two BLAS back ends by ~1e-5 of itself. Each package's error
    # against float64 stays under INPUT_STATE_REACH.
    x1, x2 = randn(12, (9, 4), (7, 4))
    want = j_input_state(x1, x2)
    got = t_input_state(*to_torch(x1, x2))
    exact = t_input_state(*to_torch(x1, x2, dtype=torch.float64))
    for field in ("nngp", "var1", "var2"):
        ref = to_numpy(getattr(exact, field))
        g, w = to_numpy(getattr(got, field)), np.asarray(getattr(want, field))
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
        assert_fp32_reach(g, w, ref, INPUT_STATE_REACH[field], f"input_state {field}")
    assert got.ntk is None
    with_ntk = t_input_state(*to_torch(x1, x2), ntk=True)
    np.testing.assert_array_equal(to_numpy(with_ntk.ntk), np.zeros((9, 7), np.float32))


@pytest.mark.parametrize("field", list(INPUT_STATE_REACH))
def test_input_state_reach_refuses_tf32(field):
    """Each INPUT_STATE_REACH ceiling refuses the state of inputs rounded to
    TF32 (a matmul that the card runs at TF32, not fp32): it errs by 3.4e-4
    to 5.2e-4 of each field's largest entry here, ~1,000x the ceilings."""
    x1, x2 = randn(12, (9, 4), (7, 4))
    want = getattr(j_input_state(x1, x2), field)
    exact = getattr(t_input_state(*to_torch(x1, x2, dtype=torch.float64)), field)
    wrong = getattr(t_input_state(_tf32(x1), _tf32(x2)), field)
    name = f"input_state {field}"
    assert_fp32_reach(exact.float(), want, exact, INPUT_STATE_REACH[field], name)
    with pytest.raises(AssertionError, match="the port errs"):
        assert_fp32_reach(wrong, want, exact, INPUT_STATE_REACH[field], name)


@pytest.mark.parametrize("layer", ["Relu", "Erf"])
def test_dual_activation_at_gram_diagonal(layer):
    # K == sqrt(v1 v2) (correlation 1) and K == -sqrt(v1 v2) hit the clip
    # at c = +-1; both tiers must agree there and stay finite.
    v = np.array([0.5, 2.0, 1.3], np.float32)
    k = np.outer(np.sqrt(v), np.sqrt(v)) * np.array([[1, -1, 0.3]] * 3, np.float32)
    from snngp.nn.state import KernelState as JS
    from snngp_torch.nn.state import KernelState as TS
    want = getattr(JL, layer)().kfn(JS(nngp=k, var1=v, var2=v))
    got = getattr(TL, layer)().kfn(TS(nngp=to_torch(k), var1=to_torch(v), var2=to_torch(v)))
    for field in ("nngp", "var1", "var2"):
        g = to_numpy(getattr(got, field))
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, np.asarray(getattr(want, field)), atol=1e-6)


def test_fanout_parallel_faninsum_identity():
    x1, x2 = randn(13, (8, 3), (5, 3))
    branch = (lambda L: L.serial(L.FanOut(2), L.parallel(
        L.serial(L.Relu(), L.Dense(4, 1.2, 0.1)), L.Identity()), L.FanInSum()))
    want = JL.kernel_fn_of(branch(JL))(x1, x2, get="nngp")
    got = TL.kernel_fn_of(branch(TL))(*to_torch(x1, x2))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-6)


def test_kernel_fn_rejects_unported_requests():
    """The NTK, once unported, now matches the JAX package's (atol 2e-6, the
    MLP bar above); an unknown ``get`` and inputs that are neither [N, D]
    nor [N, H, W, C] raise ``ValueError``, as in JAX."""
    (x,) = randn(14, (4, 3))
    kfn = TL.kernel_fn_of(tarch.get_mlp_layer(1))
    want = JL.kernel_fn_of(jarch.get_mlp_layer(1))(x, None, get="ntk")
    np.testing.assert_allclose(to_numpy(kfn(to_torch(x), get="ntk")), np.asarray(want),
                               atol=2e-6)
    with pytest.raises(ValueError):
        kfn(to_torch(x), get="nngp_diag")
    with pytest.raises(ValueError):
        kfn(to_torch(x), get=("nngp", "cov"))
    with pytest.raises(ValueError):     # neither [N, D] nor [N, H, W, C]
        kfn(torch.zeros(2, 4, 4))
