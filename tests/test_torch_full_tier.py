"""Port parity: the full spatial-covariance tier (``snngp_torch.nn.full``)
against ``snngp.nn.full`` on the same numpy inputs.

Tolerances: fp32 rtol 2e-5 / atol 1e-6, the bar of
tests/test_myrtle_pallas.py (fp32 sums of up to 9 x 8^4 terms in another
order); float64 (``jax.enable_x64``) rtol 1e-12, round-off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snngp.nn.full as JF
import snngp_torch.nn.full as TF

from _torch_parity import randn, to_numpy

HP = dict(w_std=1.3, b_std=0.2, last_w_std=1.1)


def _images(seed, n1, n2, h, c=3, dtype=np.float32):
    a, b = randn(seed, (n1, h, h, c), (n2, h, h, c))
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("depth,act", [(5, "relu"), (7, "relu"), (10, "relu"),
                                       (5, "erf"), (10, "erf")])
def test_myrtle_full_tier_matches_jax_fp32(depth, act):
    x1, x2 = _images(0, 3, 4, 8)
    want = jax.jit(lambda a, b: JF.get_myrtle_kernel(depth, 1, act, **HP)(
        a, b, get=("nngp", "ntk")))(x1, x2)
    got = TF.get_myrtle_kernel(depth, 1, act, **HP)(torch.as_tensor(x1), torch.as_tensor(x2),
                                                     get=("nngp", "ntk"))
    for g, w in zip(got, want):
        assert g.shape == (3, 4)
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "erf"])
def test_myrtle_full_tier_matches_jax_float64(act):
    """The Myrtle-5 stack up to its last pool (the JAX package's GAP casts to
    fp32; the port's keeps float64), every state in float64."""
    x1, x2 = _images(1, 2, 3, 8, dtype=np.float64)

    def stack(F):
        layers = []
        for _ in range(3):
            layers += [F.ConvF((3, 3), (1, 1), 1.3, 0.2), F.ActF(act), F.AvgPoolF((2, 2))]
        return F.serial_f(*layers)

    with jax.enable_x64(True):
        want = stack(JF)(JF.full_input_state(jnp.asarray(x1), jnp.asarray(x2)))
        want = [np.asarray(getattr(want, n)) for n in ("nngp", "cov1", "cov2")]
    got = stack(TF)(TF.full_input_state(torch.as_tensor(x1), torch.as_tensor(x2)))
    for name, w in zip(("nngp", "cov1", "cov2"), want):
        g = getattr(got, name).numpy()
        assert g.dtype == np.float64 and w.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15)


def test_layer_by_layer_states_match_jax():
    """Every field of the state after each layer of a conv / act / pool /
    conv / flatten stack, NTK included."""
    x1, x2 = _images(2, 2, 3, 8)
    stack_j = [JF.ConvF((3, 3), (1, 1), 1.2, 0.3), JF.ActF("relu"), JF.AvgPoolF((2, 2)),
               JF.ConvF((3, 3), (1, 1), 1.2, 0.3), JF.ActF("erf"), JF.FlattenF(),
               JF.DenseF(0.9, 0.1)]
    stack_t = [TF.ConvF((3, 3), (1, 1), 1.2, 0.3), TF.ActF("relu"), TF.AvgPoolF((2, 2)),
               TF.ConvF((3, 3), (1, 1), 1.2, 0.3), TF.ActF("erf"), TF.FlattenF(),
               TF.DenseF(0.9, 0.1)]
    sj = JF.full_input_state(x1, x2, ntk=True)
    st = TF.full_input_state(torch.as_tensor(x1), torch.as_tensor(x2), ntk=True)
    for fj, ft in zip(stack_j, stack_t):
        sj, st = fj(sj), ft(st)
        assert st.spatial == sj.spatial
        for name in ("nngp", "cov1", "cov2", "ntk"):
            np.testing.assert_allclose(to_numpy(getattr(st, name)),
                                       np.asarray(getattr(sj, name)), rtol=2e-5, atol=1e-6)


def test_strided_conv_and_pool_errors():
    x1, _ = _images(3, 2, 1, 6)
    k = TF.full_input_state(torch.as_tensor(x1), None).nngp
    got = TF._conv_pair(k, (3, 3), (2, 2))
    want = JF._conv_pair(jnp.asarray(to_numpy(k)), (3, 3), (2, 2))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=2e-5, atol=1e-6)
    with pytest.raises(ValueError):
        TF._pool_axis_pair(TF.full_input_state(torch.as_tensor(_images(4, 1, 1, 5)[0]),
                                               None).nngp, 2, 2)
    with pytest.raises(NotImplementedError):
        TF.AvgPoolF((2, 2), (1, 1))


def test_scan_tiled_gram_mirrors_the_upper_triangle():
    x1, x2 = _images(5, 8, 4, 8)
    kfn_t = TF.get_myrtle_kernel(5, 1, "relu", **HP)
    kfn_j = JF.get_myrtle_kernel(5, 1, "relu", **HP)
    got = TF.scan_tiled_gram(kfn_t, torch.as_tensor(x1), tile=4, chunk=3, remat=True)
    want = JF.scan_tiled_gram(kfn_j, jnp.asarray(x1), tile=4, chunk=3)
    assert isinstance(got, np.ndarray) and got.shape == (8, 8)
    np.testing.assert_array_equal(got[4:, :4], got[:4, 4:].T)   # the mirrored block
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    cross = TF.scan_tiled_gram(kfn_t, torch.as_tensor(x1), torch.as_tensor(x2), tile=4)
    np.testing.assert_allclose(cross, to_numpy(kfn_t(torch.as_tensor(x1),
                                                     torch.as_tensor(x2))), rtol=1e-6)
    with pytest.raises(ValueError, match="tile"):
        TF.scan_tiled_gram(kfn_t, torch.as_tensor(x1[:6]), tile=4)


def test_trainable_input_gradients_match_jax():
    """Autograd through the port's tier (the backward of the fused Gram's
    trainable_inputs=True contract) against jax.grad, scales and x."""
    x1, x2 = _images(6, 2, 3, 8)
    g = randn(7, (2, 3))[0]

    def loss_j(a, b, w, bs, l):
        return jnp.sum(g * JF.get_myrtle_kernel(5, 1, "relu", w_std=w, b_std=bs,
                                                last_w_std=l)(a, b))

    want = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3, 4)))(x1, x2, 1.3, 0.2, 1.1)
    leaves = [torch.tensor(v, requires_grad=True) for v in (x1, x2, 1.3, 0.2, 1.1)]
    k = TF.get_myrtle_kernel(5, 1, "relu", w_std=leaves[2], b_std=leaves[3],
                             last_w_std=leaves[4])(leaves[0], leaves[1])
    got = torch.autograd.grad(torch.sum(torch.as_tensor(g) * k), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-4, atol=1e-6)
