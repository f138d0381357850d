"""Compositional NNGP / NTK layers (counterpart of ``snngp/nn/layers.py``).

Each layer is a :class:`Layer` with

- ``kfn``:   the closed-form covariance recursion, state -> state;
- ``init``:  finite-width parameters, ``(generator, in_shape) -> (out_shape,
  params)``;
- ``apply``: the finite-width forward, ``(params, x) -> y``;

in the NTK parameterization (weights ~ N(0, 1) scaled by
``w_std / sqrt(fan_in)``, biases ~ N(0, 1) scaled by ``b_std``):

- Dense(w, b):   K' = w^2 K + b^2
- Conv 3x3:      K' = w^2 patch_mean(K) + b^2 (matched-pixel tier: i.i.d.
                 filter offsets couple only equal offsets across the inputs)
- Relu:          arccos kernel  K' = (s sin t + (pi - t) K) / (2 pi),
                 s = sqrt(v1 v2), t = arccos(K / s)
- Erf:           arcsin kernel  K' = (2/pi) asin(2K / sqrt((1+2v1)(1+2v2)))
- Flatten:       spatial mean (exact for a Flatten + Dense readout)
- AvgPool / GlobalAvgPool: window / global means (full tier only)
- FanOut/parallel/FanInSum/Identity: residual-branch bookkeeping.

The NTK rides the same recursion when asked for: affine T' = K' + w^2 T;
nonlinearity T' = T E[phi'(u) phi'(v)], which is (pi - t) / (2 pi) for
relu and (4/pi) / sqrt((1+2v1)(1+2v2) - 4K^2) for erf; Flatten takes the
spatial mean; FanInSum the sum.

Every ``kfn`` takes either tier's state: the matched-pixel
:class:`~snngp_torch.nn.state.KernelState` (exact for Flatten readouts,
cheap) or the full pixel-pair
:class:`~snngp_torch.nn.full.FullKernelState` (exact for pooled readouts),
dispatching on its type. One composed Layer serves both:
``kernel_fn_of(layer, full=True)``. This tier materializes every layer's
state; the architectures' kernel functions (:mod:`snngp_torch.nn.arch`)
route NNGP Gram blocks to the fused Grams instead, and keep this tier as
the independent reference, as the backward of the fused Grams'
``trainable_inputs=True`` contract and as the route of the NTK. The arccos
kernel carries the JAX package's analytic backward, finite on the Gram's
diagonal.

Finite-width params are nested tuples of tensors in the JAX pytree's
structure and layouts: Dense ``w`` is ``[d, out]``, Conv ``w`` is HWIO
``[fh, fw, c_in, c_out]``, and inputs are NHWC, so a JAX checkpoint's
arrays load with no transposes (:mod:`snngp_torch.nn.finite`). ``init``
draws from the ``torch.Generator`` it is given, on that generator's device,
layer after layer (the JAX package splits a key per layer: the draws
differ, their distribution does not).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from snngp_torch.nn import full as _full
from snngp_torch.nn.state import KernelState, input_state

__all__ = [
    "Layer",
    "Dense",
    "Conv",
    "Relu",
    "Erf",
    "Flatten",
    "Identity",
    "FanOut",
    "FanInSum",
    "AvgPool",
    "GlobalAvgPool",
    "serial",
    "parallel",
    "kernel_fn_of",
]

_TINY = 1e-30


def _is_full(k) -> bool:
    """True for the full spatial-covariance state (the JAX package's
    ``_is_full``)."""
    return isinstance(k, _full.FullKernelState)


@dataclasses.dataclass(frozen=True)
class Layer:
    kfn: Callable[[Any], Any]
    init: Callable[[torch.Generator, tuple], tuple]
    apply: Callable[[Any, Any], Any]


def _no_params(generator, in_shape):
    return in_shape, ()


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def Dense(out_dim: int, w_std, b_std=0.0) -> Layer:
    """Fully-connected layer, NTK parameterization (stax.Dense analogue)."""

    def kfn(k):
        if _is_full(k):
            return _full.DenseF(w_std, b_std)(k)
        w2 = w_std * w_std
        b2 = b_std * b_std
        nngp = w2 * k.nngp + b2
        return KernelState(nngp=nngp, var1=w2 * k.var1 + b2, var2=w2 * k.var2 + b2,
                           ntk=None if k.ntk is None else nngp + w2 * k.ntk)

    def init(generator, in_shape):
        w = _normal(generator, (in_shape[-1], out_dim))
        b = _normal(generator, (out_dim,))
        return tuple(in_shape[:-1]) + (out_dim,), (w, b)

    def apply(params, x):
        w, b = params
        return (w_std / math.sqrt(x.shape[-1])) * (x @ w) + b_std * b

    return Layer(kfn, init, apply)


def _same_pads(n: int, k: int, s: int):
    """(low, high) zero padding of ``lax.conv``'s SAME alignment on one axis:
    ceil(n / s) outputs, the odd padding pixel at the high end."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _patch_mean(img: torch.Tensor, filter_shape, strides) -> torch.Tensor:
    """SAME-padded stencil mean over the filter offsets, [..., H, W] ->
    [..., H', W'] (zeros off the edge): the JAX package's depthwise all-ones
    conv / filter count, with ``lax.conv``'s SAME alignment (stride 2 pads
    an even extent at the high end only)."""
    batch_shape = img.shape[:-2]
    h, w = img.shape[-2:]
    (fh, fw), (sh, sw) = filter_shape, strides
    top, bottom = _same_pads(h, fh, sh)
    left, right = _same_pads(w, fw, sw)
    x = F.pad(img.reshape(-1, 1, h, w), (left, right, top, bottom))
    out = F.avg_pool2d(x, (fh, fw), (sh, sw))
    return out.reshape(batch_shape + out.shape[-2:])


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, strides) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, strides, "SAME")`` on NHWC inputs and
    an HWIO filter: ``F.conv2d`` on permuted views, padded by
    :func:`_same_pads` first (``conv2d``'s ``padding=`` is symmetric, and
    SAME at stride 2 on an even extent pads only the high end)."""
    top, bottom = _same_pads(x.shape[1], w.shape[0], strides[0])
    left, right = _same_pads(x.shape[2], w.shape[1], strides[1])
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom)),
                 w.permute(3, 2, 0, 1), stride=tuple(strides))
    return y.permute(0, 2, 3, 1)


def Conv(out_chan: int, filter_shape=(3, 3), strides=(1, 1), padding: str = "SAME",
         w_std=1.0, b_std=0.0) -> Layer:
    """2-D convolution, NTK parameterization (stax.Conv analogue), on the
    matched-pixel state: ``K'[i, j, p] = w^2 mean_d K[i, j, s p + d] + b^2``
    (zeros off the edge)."""
    if padding != "SAME":
        raise NotImplementedError("only SAME padding (all reference archs use SAME)")

    def kfn(k):
        if _is_full(k):
            return _full.ConvF(filter_shape, strides, w_std, b_std)(k)
        if not k.spatial:
            raise ValueError("Conv requires spatial kernel state ([N,H,W,C] inputs)")
        w2 = w_std * w_std
        b2 = b_std * b_std
        nngp = w2 * _patch_mean(k.nngp, filter_shape, strides) + b2
        ntk = None if k.ntk is None else nngp + w2 * _patch_mean(k.ntk, filter_shape, strides)
        return KernelState(nngp=nngp,
                           var1=w2 * _patch_mean(k.var1, filter_shape, strides) + b2,
                           var2=w2 * _patch_mean(k.var2, filter_shape, strides) + b2,
                           ntk=ntk)

    def init(generator, in_shape):
        w = _normal(generator, tuple(filter_shape) + (in_shape[-1], out_chan))
        b = _normal(generator, (out_chan,))
        h, wdim = in_shape[-3:-1]
        out_shape = (tuple(in_shape[:-3]) + (-(-h // strides[0]), -(-wdim // strides[1]),
                                             out_chan))
        return out_shape, (w, b)

    def apply(params, x):
        w, b = params
        fan_in = filter_shape[0] * filter_shape[1] * x.shape[-1]
        return (w_std / math.sqrt(fan_in)) * _conv_nhwc(x, w, strides) + b_std * b

    return Layer(kfn, init, apply)


def _outer(k: KernelState):
    """var1 [N1, ...] and var2 [N2, ...] broadcast against nngp [N1, N2, ...]."""
    return k.var1[:, None], k.var2[None, :]


class _ReluT(torch.autograd.Function):
    """Arccos kernel with the JAX package's analytic derivatives, which are
    finite at c = +-1 (the Gram's diagonal), where autograd through
    ``acos`` gives NaN:

        dT/dK = (pi - theta) / (2 pi),  dT/dv1 = sin(theta) v2 / (4 pi s),

    and symmetrically for v2 (``snngp/nn/layers.py:_relu_t_jvp``), in both
    modes: ``backward`` for reverse-mode autograd, ``jvp`` for
    ``torch.func.jvp`` (the Myrtle variance profiles' scale tangents).

    ``forward`` also returns s, theta and sin(theta), marked
    non-differentiable, so that both rules read them saved instead of
    recomputing them (``torch.func`` needs ``setup_context``, which sees only
    inputs and outputs); :func:`_relu_t` returns the first output. Their
    cotangents are not materialized: ``backward`` gets ``None`` for them."""

    @staticmethod
    def forward(nngp, v1, v2):
        s = torch.sqrt(torch.clamp(v1 * v2, min=_TINY))
        theta = torch.acos(torch.clamp(nngp / s, -1.0, 1.0))
        sin_t = torch.sin(theta)
        return (s * sin_t + (math.pi - theta) * nngp) / (2.0 * math.pi), s, theta, sin_t

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, v1, v2 = inputs
        ctx.mark_non_differentiable(*output[1:])
        ctx.set_materialize_grads(False)   # no zero cotangents for the extra outputs
        ctx.save_for_backward(v1, v2, *output[1:])
        ctx.save_for_forward(v1, v2, *output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        v1, v2, s, theta, sin_t = ctx.saved_tensors
        q = g * sin_t / (4.0 * math.pi * s)
        return ((g * ((math.pi - theta) / (2.0 * math.pi))),
                (q * v2).sum_to_size(v1.shape), (q * v1).sum_to_size(v2.shape))

    @staticmethod
    def jvp(ctx, dk, dv1, dv2):
        v1, v2, s, theta, sin_t = ctx.saved_tensors
        q = sin_t / (4.0 * math.pi * s)
        out = torch.zeros_like(s * theta)
        if dk is not None:
            out = out + ((math.pi - theta) / (2.0 * math.pi)) * dk
        if dv1 is not None:
            out = out + q * v2 * dv1
        if dv2 is not None:
            out = out + q * v1 * dv2
        return out, None, None, None


def _relu_t(nngp, v1, v2):
    """Arccos kernel T(K) = E[relu(u) relu(v)] for (u,v) ~ N(0, [[v1,K],[K,v2]])."""
    return _ReluT.apply(nngp, v1, v2)[0]


def _relu_tdot(nngp, v1, v2):
    """E[relu'(u) relu'(v)] = P(u > 0, v > 0) = (pi - theta) / (2 pi)."""
    s = torch.sqrt(torch.clamp(v1 * v2, min=_TINY))
    return (math.pi - torch.acos(torch.clamp(nngp / s, -1.0, 1.0))) / (2.0 * math.pi)


def Relu() -> Layer:
    def kfn(k):
        if _is_full(k):
            return _full.ActF("relu")(k)
        b1, b2 = _outer(k)
        return KernelState(nngp=_relu_t(k.nngp, b1, b2), var1=k.var1 / 2.0,
                           var2=k.var2 / 2.0,
                           ntk=None if k.ntk is None else k.ntk * _relu_tdot(k.nngp, b1, b2))

    return Layer(kfn, _no_params, lambda params, x: torch.relu(x))


def _erf_t(nngp, v1, v2):
    """Arcsin kernel T(K) = E[erf(u) erf(v)] = (2/pi) asin(2K / sqrt((1+2v1)(1+2v2)))."""
    denom = torch.sqrt((1.0 + 2.0 * v1) * (1.0 + 2.0 * v2))
    return (2.0 / math.pi) * torch.asin(torch.clamp(2.0 * nngp / denom, -1.0, 1.0))


def _erf_tdot(nngp, v1, v2):
    """E[erf'(u) erf'(v)] = (4/pi) / sqrt((1+2v1)(1+2v2) - 4K^2)."""
    det = (1.0 + 2.0 * v1) * (1.0 + 2.0 * v2) - 4.0 * nngp * nngp
    return (4.0 / math.pi) / torch.sqrt(torch.clamp(det, min=_TINY))


def Erf() -> Layer:
    def kfn(k):
        if _is_full(k):
            return _full.ActF("erf")(k)
        b1, b2 = _outer(k)
        return KernelState(nngp=_erf_t(k.nngp, b1, b2),
                           var1=_erf_t(k.var1, k.var1, k.var1),
                           var2=_erf_t(k.var2, k.var2, k.var2),
                           ntk=None if k.ntk is None else k.ntk * _erf_tdot(k.nngp, b1, b2))

    return Layer(kfn, _no_params, lambda params, x: torch.erf(x))


def Flatten() -> Layer:
    """Spatial mean readout (exact for Flatten -> Dense; stax.Flatten
    analogue); a no-op on a flat state. ``apply`` reshapes in NHWC order,
    so a JAX readout weight multiplies the same features."""

    def kfn(k):
        if _is_full(k):
            return _full.FlattenF()(k) if k.spatial else k
        if not k.spatial:
            return k
        mean = lambda t: torch.mean(t, dim=(-2, -1))  # noqa: E731
        return KernelState(nngp=mean(k.nngp), var1=mean(k.var1), var2=mean(k.var2),
                           ntk=None if k.ntk is None else mean(k.ntk))

    def init(generator, in_shape):
        if len(in_shape) == 2:
            return in_shape, ()
        return (in_shape[0], math.prod(in_shape[1:])), ()

    return Layer(kfn, init, lambda params, x: x.reshape(x.shape[0], -1))


def AvgPool(window=(2, 2), strides=None) -> Layer:
    """Non-overlapping average pooling (stax.AvgPool analogue). Its kernel
    recursion exists only on the full spatial-covariance tier: pooling
    mixes different pixels, which the matched-pixel state drops."""
    if strides is not None and tuple(strides) != tuple(window):
        raise NotImplementedError("only window == strides pooling")
    win = window[0]

    def kfn(k):
        if _is_full(k):
            return _full.AvgPoolF(window)(k)
        raise NotImplementedError(
            "exact NNGP average pooling requires the full spatial-covariance "
            "tier: build the kernel with kernel_fn_of(layer, full=True)")

    def init(generator, in_shape):
        n, h, w, c = in_shape
        return (n, h // win, w // win, c), ()

    def apply(params, x):
        n, h, w, c = x.shape
        return x.reshape(n, h // win, win, w // win, win, c).mean(dim=(2, 4))

    return Layer(kfn, init, apply)


def GlobalAvgPool() -> Layer:
    """Global average pool over the spatial dims; its kernel recursion
    exists only on the full spatial-covariance tier, as :func:`AvgPool`'s."""

    def kfn(k):
        if _is_full(k):
            return _full.GlobalAvgPoolF()(k)
        raise NotImplementedError(
            "exact NNGP global pooling requires the full spatial-covariance "
            "tier: build the kernel with kernel_fn_of(layer, full=True)"
        )

    return Layer(kfn, lambda generator, in_shape: ((in_shape[0], in_shape[-1]), ()),
                 lambda params, x: torch.mean(x, dim=(1, 2)))


def Identity() -> Layer:
    return Layer(lambda k: k, _no_params, lambda params, x: x)


def FanOut(n: int) -> Layer:
    return Layer(lambda k: tuple(k for _ in range(n)),
                 lambda generator, in_shape: (tuple(in_shape for _ in range(n)), ()),
                 lambda params, x: tuple(x for _ in range(n)))


def FanInSum() -> Layer:
    """Sum of parallel branches: branch outputs have zero cross-covariance
    (each weighted branch ends in an independent zero-mean affine layer),
    so kernels add."""

    def kfn(ks):
        nngp = sum(k.nngp for k in ks)
        ntk = None if ks[0].ntk is None else sum(k.ntk for k in ks)
        if _is_full(ks[0]):
            return _full.FullKernelState(nngp, sum(k.cov1 for k in ks),
                                         sum(k.cov2 for k in ks), ntk)
        return KernelState(nngp=nngp, var1=sum(k.var1 for k in ks),
                           var2=sum(k.var2 for k in ks), ntk=ntk)

    def apply(params, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    return Layer(kfn, lambda generator, in_shapes: (in_shapes[0], ()), apply)


def serial(*layers: Layer) -> Layer:
    def kfn(k):
        for layer in layers:
            k = layer.kfn(k)
        return k

    def init(generator, in_shape):
        params = []
        for layer in layers:
            in_shape, p = layer.init(generator, in_shape)
            params.append(p)
        return in_shape, tuple(params)

    def apply(params, x):
        for layer, p in zip(layers, params):
            x = layer.apply(p, x)
        return x

    return Layer(kfn, init, apply)


def parallel(*layers: Layer) -> Layer:
    def init(generator, in_shapes):
        outs = [layer.init(generator, s) for layer, s in zip(layers, in_shapes)]
        return tuple(s for s, _ in outs), tuple(p for _, p in outs)

    return Layer(lambda ks: tuple(layer.kfn(k) for layer, k in zip(layers, ks)), init,
                 lambda params, xs: tuple(layer.apply(p, x)
                                          for layer, p, x in zip(layers, params, xs)))


def kernel_fn_of(layer: Layer, full: bool = False, dtype=None):
    """Turn a composed Layer into ``kernel_fn(x1, x2=None, get="nngp")``;
    ``get`` is "nngp", "ntk" or a tuple of them (then a tuple comes back).

    ``full=True`` runs the same Layer on the full spatial-covariance tier
    (:mod:`snngp_torch.nn.full`), which pooled readouts need; ``dtype``
    stores its 6-D state in that dtype (e.g. ``torch.bfloat16``). The
    default matched-pixel tier is exact for Flatten readouts and far
    cheaper."""

    def kernel_fn(x1, x2=None, get="nngp"):
        want = (get,) if isinstance(get, str) else tuple(get)
        for g in want:
            if g not in ("nngp", "ntk"):
                raise ValueError(f"unknown get={g!r}")
        if full:
            state = layer.kfn(_full.full_input_state(x1, x2, ntk="ntk" in want, dtype=dtype))
        else:
            state = layer.kfn(input_state(x1, x2, ntk="ntk" in want))
        outs = tuple(state.nngp if g == "nngp" else state.ntk for g in want)
        return outs[0] if isinstance(get, str) else outs

    return kernel_fn
