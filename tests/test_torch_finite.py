"""Port parity: the finite-width half of the layer tier
(snngp_torch/nn/layers.py ``init`` / ``apply``, snngp_torch/nn/finite.py)
against snngp.nn.layers, with JAX's ``init`` params handed to the port.

Tolerances:
- ``apply``: 1e-5 of the largest magnitude of JAX's output (fp32
  convolutions and products of two frameworks, which differ in the last
  bits only);
- ``init``: the same shapes and tree structure as JAX's; the draws' mean
  and variance within 5 standard errors of N(0, 1)'s (1 / sqrt(n) and
  sqrt(2 / n));
- ``params_from_jax`` / ``params_to_numpy``: bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from snngp.nn import arch as jarch
from snngp.nn import layers as JL

from snngp_torch.nn import arch as tarch
from snngp_torch.nn import layers as TL
from snngp_torch.nn.finite import FiniteNet, params_from_jax, params_to_numpy
from snngp_torch.utils import Adam

from _torch_parity import randn, to_numpy

# name -> (layer of either package, input shape).
LAYERS = {
    "dense": (lambda L: L.Dense(7, w_std=1.3, b_std=0.4), (4, 5)),
    "dense-on-images": (lambda L: L.Dense(3, w_std=0.8, b_std=0.2), (2, 5, 4, 6)),
    "conv-s1-odd": (lambda L: L.Conv(4, (3, 3), (1, 1), w_std=1.2, b_std=0.3), (2, 7, 5, 3)),
    "conv-s1-even": (lambda L: L.Conv(4, (3, 3), (1, 1), w_std=1.2, b_std=0.3), (2, 8, 6, 3)),
    "conv-s2-odd": (lambda L: L.Conv(5, (3, 3), (2, 2), w_std=0.9, b_std=0.1), (2, 7, 9, 2)),
    "conv-s2-even": (lambda L: L.Conv(5, (3, 3), (2, 2), w_std=0.9, b_std=0.1), (2, 8, 6, 2)),
    "conv-s2-mixed": (lambda L: L.Conv(3, (3, 3), (2, 2), w_std=1.1, b_std=0.2), (1, 8, 7, 2)),
    "relu": (lambda L: L.Relu(), (3, 4, 4, 2)),
    "erf": (lambda L: L.Erf(), (3, 4, 4, 2)),
    "flatten": (lambda L: L.Flatten(), (3, 4, 5, 2)),
    "avgpool": (lambda L: L.AvgPool((2, 2)), (2, 4, 6, 3)),
    "globalavgpool": (lambda L: L.GlobalAvgPool(), (2, 4, 6, 3)),
    "identity": (lambda L: L.Identity(), (2, 3)),
    "residual": (lambda L: L.serial(
        L.FanOut(2),
        L.parallel(L.serial(L.Relu(), L.Conv(2, (3, 3), (1, 1), w_std=1.1, b_std=0.1)),
                   L.Identity()),
        L.FanInSum()), (2, 5, 5, 2)),
    # Flatten in NHWC order: a JAX readout weight multiplies the same features.
    "cnn": (lambda L: (jarch if L is JL else tarch).get_cnn_layer(
        2, 3, "relu", 1.3, 0.2, 0.9, channels=4), (2, 6, 5, 2)),
    "conv-resnet": (lambda L: (jarch if L is JL else tarch).get_conv_resnet_layer(
        1, 2, "erf", 1.2, 0.1, 0.8, k=1), (2, 8, 8, 3)),
    "mlp": (lambda L: (jarch if L is JL else tarch).get_mlp_layer(
        2, 2, "erf", 1.4, 0.3, 0.7, width=16), (3, 6)),
    "dense-resnet": (lambda L: (jarch if L is JL else tarch).get_dense_resnet_layer(
        2, 1, "relu", 1.1, 0.2, 0.9, width=8), (3, 6)),
}


def _jax_init(name, seed=0):
    layer = LAYERS[name][0](JL)
    out_shape, params = layer.init(jax.random.PRNGKey(seed), LAYERS[name][1])
    return layer, out_shape, jax.device_get(params)


def _shapes(tree):
    if isinstance(tree, tuple):
        return tuple(_shapes(t) for t in tree)
    return tuple(tree.shape)


@pytest.mark.parametrize("name", list(LAYERS))
def test_apply_matches_jax_with_jax_params(name):
    jlayer, _, params = _jax_init(name)
    (x,) = randn(40, LAYERS[name][1])
    want = jlayer.apply(params, x)
    got = LAYERS[name][0](TL).apply(params_from_jax(params), torch.as_tensor(x))
    assert tuple(got.shape) == tuple(want.shape)
    err = np.max(np.abs(to_numpy(got) - np.asarray(want))) / np.max(np.abs(np.asarray(want)))
    assert err <= 1e-5, err


def test_fanout_parallel_apply_keeps_branches():
    jlayer = JL.serial(JL.FanOut(2), JL.parallel(JL.Dense(3, 1.0), JL.Erf()))
    tlayer = TL.serial(TL.FanOut(2), TL.parallel(TL.Dense(3, 1.0), TL.Erf()))
    _, params = jlayer.init(jax.random.PRNGKey(1), (4, 5))
    (x,) = randn(41, (4, 5))
    want = jlayer.apply(jax.device_get(params), x)
    got = tlayer.apply(params_from_jax(jax.device_get(params)), torch.as_tensor(x))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(LAYERS))
def test_init_shapes_match_jax(name):
    _, want_shape, want_params = _jax_init(name)
    generator = torch.Generator().manual_seed(0)
    got_shape, got_params = LAYERS[name][0](TL).init(generator, LAYERS[name][1])
    assert tuple(got_shape) == tuple(want_shape)
    assert _shapes(got_params) == _shapes(want_params)


def test_init_draws_are_standard_normal():
    generator = torch.Generator().manual_seed(3)
    _, (w, b) = TL.Dense(512, 1.0).init(generator, (-1, 256))
    _, (cw, _) = TL.Conv(64, (3, 3)).init(generator, (-1, 8, 8, 32))
    for draws in (w, cw, torch.cat([w.flatten(), b])):
        n = draws.numel()
        d = draws.double()
        assert abs(float(d.mean())) <= 5 / np.sqrt(n)
        assert abs(float(d.var()) - 1.0) <= 5 * np.sqrt(2.0 / n)


def test_init_uses_the_generators_device_and_stream():
    layer = tarch.get_cnn_layer(1, 2, "relu", channels=3)
    a = layer.init(torch.Generator().manual_seed(5), (-1, 6, 6, 1))[1]
    b = layer.init(torch.Generator().manual_seed(5), (-1, 6, 6, 1))[1]
    for (wa, ba), (wb, bb) in ((a[0], b[0]), (a[-1], b[-1])):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
        assert wa.device == torch.device("cpu")


@pytest.mark.parametrize("name", ["cnn", "conv-resnet", "residual"])
def test_params_round_trip_bitwise(name):
    _, _, params = _jax_init(name, seed=4)
    back = params_to_numpy(params_from_jax(params))
    assert _shapes(back) == _shapes(params)
    for (_, a), (_, b) in zip(_leaves(params), _leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # An object ndarray (a recursing np.array save) reads as the tuple.
    mangled = np.empty(len(params), dtype=object)
    for i, p in enumerate(params):
        mangled[i] = p
    assert _shapes(params_to_numpy(params_from_jax(mangled))) == _shapes(params)


def _leaves(tree, path=()):
    if isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    else:
        yield path, tree


def test_finite_net_holds_params_in_pytree_order():
    """FiniteNet's sorted parameter names are the pytree's leaf order (the
    optimizers' order); its forward is ``apply``; an Adam step moves every
    weight and ``params()`` gives them back in ``init``'s structure."""
    _, _, params = _jax_init("cnn", seed=6)
    layer = LAYERS["cnn"][0](TL)
    net = FiniteNet(layer, params_from_jax(params))
    names = sorted(n for n, _ in net.named_parameters())
    assert [tuple(p.shape) for n, p in sorted(net.named_parameters())] == \
        [a.shape for _, a in _leaves(params)]
    assert names == [FiniteNet._name(path) for path, _ in _leaves(params)]
    (x,) = randn(42, (2, 6, 5, 2))
    x = torch.as_tensor(x)
    np.testing.assert_array_equal(to_numpy(net(x)),
                                  to_numpy(layer.apply(params_from_jax(params), x)))
    opt = Adam(net)
    opt.zero_grad()
    net(x).square().sum().backward()
    opt.update(1e-2)
    moved = params_to_numpy(net.params())
    assert _shapes(moved) == _shapes(params)
    for (_, a), (_, b) in zip(_leaves(params), _leaves(moved)):
        assert a.ndim == 1 or not np.array_equal(a, b)   # the readout bias has b_std 0
