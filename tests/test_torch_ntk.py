"""Port parity: the NTK of the layer tier (snngp_torch/nn/layers.py,
state.py, full.py, arch.py) against snngp.nn on the same inputs.

Tolerances, relative to the largest magnitude of the JAX result:
- float32: 1e-5, the repo's fp32 bar for the kernel recursions (the two
  frameworks' matmul, acos and asin differ in the last bits only);
- float64 (``jax.enable_x64``): 1e-12, round-off;
- the empirical NTK of the port's finite nets (``torch.func.jacrev``,
  averaged over 64 inits of a depth-2 width-256 ReLU MLP) against the
  analytic NTK: atol 0.25, the JAX package's own bar for this check
  (tests/test_nn_kernels.py:149; width 512 over 40 inits there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snngp.nn import arch as jarch
from snngp.nn import layers as JL

from snngp_torch.nn import arch as tarch
from snngp_torch.nn import layers as TL

from _torch_parity import randn, to_numpy

SCALES = dict(w_std=1.3, b_std=0.2, last_w_std=0.9)
# name -> (kernel function of either package's arch module, shapes of x1
# and x2): the four reference networks.
NETS = {
    "mlp": (lambda A, act: A.get_mlp_kernel(2, 1, act, **SCALES), [(6, 5), (4, 5)]),
    "dense-resnet": (lambda A, act: A.get_dense_resnet_kernel(2, 1, act, **SCALES),
                     [(6, 5), (4, 5)]),
    "cnn": (lambda A, act: A.get_cnn_kernel(2, 1, act, **SCALES),
            [(3, 6, 5, 2), (2, 6, 5, 2)]),
    "conv-resnet": (lambda A, act: A.get_conv_resnet_kernel(1, 1, act, **SCALES),
                    [(3, 4, 4, 2), (2, 4, 4, 2)]),
}


def _rel(got, want):
    got, want = to_numpy(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("get", ["ntk", ("nngp", "ntk")], ids=["ntk", "nngp+ntk"])
@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("net", list(NETS))
def test_ntk_matches_jax_fp32(net, act, get):
    build, shapes = NETS[net]
    x1, x2 = randn(30, *shapes)
    want = build(jarch, act)(jnp.asarray(x1), jnp.asarray(x2), get=get)
    got = build(tarch, act)(torch.as_tensor(x1), torch.as_tensor(x2), get=get)
    if isinstance(get, str):
        want, got = (want,), (got,)
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("act", ["relu", "erf"])
@pytest.mark.parametrize("net", list(NETS))
def test_ntk_matches_jax_float64(net, act):
    build, shapes = NETS[net]
    x1, x2 = (x.astype(np.float64) for x in randn(31, *shapes))
    with jax.enable_x64(True):
        want = build(jarch, act)(jnp.asarray(x1), jnp.asarray(x2), get=("nngp", "ntk"))
        want = [np.asarray(w) for w in want]
    got = build(tarch, act)(torch.as_tensor(x1), torch.as_tensor(x2), get=("nngp", "ntk"))
    for g, w in zip(got, want):
        assert w.dtype == np.float64
        assert _rel(g, w) <= 1e-12


def _pooled(L):
    """Conv, a residual block, pools and a GAP readout: every full-tier path
    of the layer tier's ``kfn`` (FanInSum's included)."""
    block = L.serial(L.FanOut(2), L.parallel(
        L.serial(L.Relu(), L.Conv(1, (3, 3), (1, 1), "SAME", w_std=1.2, b_std=0.1)),
        L.Identity()), L.FanInSum())
    return L.serial(L.Conv(1, (3, 3), (1, 1), "SAME", w_std=1.1, b_std=0.2), block,
                    L.AvgPool((2, 2)), L.Erf(),
                    L.Conv(1, (3, 3), (2, 2), "SAME", w_std=1.3, b_std=0.1), L.Relu(),
                    L.GlobalAvgPool(), L.Dense(1, w_std=0.8, b_std=0.05))


@pytest.mark.parametrize("get", ["nngp", "ntk", ("nngp", "ntk")], ids=["nngp", "ntk", "both"])
def test_full_tier_kernel_fn_matches_jax(get):
    x1, x2 = randn(32, (3, 4, 4, 2), (2, 4, 4, 2))
    want = JL.kernel_fn_of(_pooled(JL), full=True)(jnp.asarray(x1), jnp.asarray(x2), get=get)
    got = TL.kernel_fn_of(_pooled(TL), full=True)(torch.as_tensor(x1), torch.as_tensor(x2),
                                                  get=get)
    if isinstance(get, str):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


def test_full_tier_flatten_readout_matches_matched_tier():
    """On a Flatten readout both tiers are exact, so they agree, NTK too (the
    JAX package's cross-tier check, tests/test_full_tier.py:172-177)."""
    (x,) = randn(33, (3, 6, 6, 2))
    layer = tarch.get_cnn_layer(2, 1, "erf", 1.1, 0.2, 0.9)
    matched = TL.kernel_fn_of(layer)(torch.as_tensor(x), get=("nngp", "ntk"))
    full = TL.kernel_fn_of(layer, full=True)(torch.as_tensor(x), get=("nngp", "ntk"))
    for m, f in zip(matched, full):
        assert _rel(f, m) <= 1e-5


@pytest.mark.parametrize("pool", ["AvgPool", "GlobalAvgPool"])
def test_pooling_needs_the_full_tier(pool):
    (x,) = randn(34, (2, 4, 4, 1))
    kfn = TL.kernel_fn_of(TL.serial(getattr(TL, pool)(), TL.Flatten()))
    with pytest.raises(NotImplementedError, match="requires the full spatial-covariance"):
        kfn(torch.as_tensor(x))


def test_empirical_ntk_converges_to_analytic():
    """The port's finite nets: sum over params of J J^T, averaged over
    inits, against the analytic NTK (the JAX package's
    test_ntk_recursion_matches_finite_width_mc, at width 256 over 64 inits)."""
    (x,) = randn(35, (3, 4))
    x = torch.as_tensor(x)
    theta = tarch.get_mlp_kernel(2, 1, "relu", w_std=1.0, b_std=0.5, last_w_std=1.0)(
        x, x, get="ntk")
    layer = tarch.get_mlp_layer(2, 1, "relu", 1.0, 0.5, 1.0, width=256)
    generator = torch.Generator().manual_seed(9)

    def empirical_ntk():
        _, params = layer.init(generator, tuple(x.shape))
        jac = torch.func.jacrev(lambda p: layer.apply(p, x)[:, 0])(params)
        leaves = [leaf for layer_jac in jac for leaf in layer_jac]
        return sum(torch.tensordot(j, j, dims=(list(range(1, j.ndim)),) * 2)
                   for j in leaves)

    ntk_mc = torch.stack([empirical_ntk() for _ in range(64)]).mean(dim=0)
    np.testing.assert_allclose(to_numpy(theta), to_numpy(ntk_mc), atol=0.25)
