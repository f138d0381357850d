"""Compositional NNGP layers, the kernel tier (counterpart of
``snngp/nn/layers.py``).

Each layer is a :class:`Layer` whose ``kfn`` maps a
:class:`~snngp_torch.nn.state.KernelState` to the next one, forward only:

- Dense(w, b):   K' = w^2 K + b^2
- Conv 3x3:      K' = w^2 patch_mean(K) + b^2 (matched-pixel tier: i.i.d.
                 filter offsets couple only equal offsets across the inputs)
- Relu:          arccos kernel  K' = (s sin t + (pi - t) K) / (2 pi),
                 s = sqrt(v1 v2), t = arccos(K / s)
- Erf:           arcsin kernel  K' = (2/pi) asin(2K / sqrt((1+2v1)(1+2v2)))
- Flatten:       spatial mean (exact for a Flatten + Dense readout)
- FanOut/parallel/FanInSum/Identity: residual-branch bookkeeping.

This tier materializes every layer's [N1, N2] or [N1, N2, H, W] state; the
architectures' kernel functions (:mod:`snngp_torch.nn.arch`) route Gram
blocks to the fused Grams instead, and keep this tier as the independent
reference and as the backward of the fused Grams' ``trainable_inputs=True``
contract. The arccos kernel carries the JAX package's analytic backward,
finite on the Gram's diagonal. The finite-width ``init``/``apply``, the
pooling layers (full spatial-covariance tier) and the NTK land in later
slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

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
    "serial",
    "parallel",
    "kernel_fn_of",
]

_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class Layer:
    kfn: Callable[[Any], Any]


def Dense(out_dim: int, w_std, b_std=0.0) -> Layer:
    """Fully-connected layer, NTK parameterization (stax.Dense analogue).
    ``out_dim`` only matters to the finite-width tier."""

    def kfn(k: KernelState) -> KernelState:
        w2 = w_std * w_std
        b2 = b_std * b_std
        return KernelState(nngp=w2 * k.nngp + b2, var1=w2 * k.var1 + b2,
                           var2=w2 * k.var2 + b2)

    return Layer(kfn)


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


def Conv(out_chan: int, filter_shape=(3, 3), strides=(1, 1), padding: str = "SAME",
         w_std=1.0, b_std=0.0) -> Layer:
    """2-D convolution, NTK parameterization (stax.Conv analogue), on the
    matched-pixel state: ``K'[i, j, p] = w^2 mean_d K[i, j, s p + d] + b^2``
    (zeros off the edge). ``out_chan`` only matters to the finite-width
    tier."""
    if padding != "SAME":
        raise NotImplementedError("only SAME padding (all reference archs use SAME)")

    def kfn(k: KernelState) -> KernelState:
        if not k.spatial:
            raise ValueError("Conv requires spatial kernel state ([N,H,W,C] inputs)")
        w2 = w_std * w_std
        b2 = b_std * b_std
        return KernelState(nngp=w2 * _patch_mean(k.nngp, filter_shape, strides) + b2,
                           var1=w2 * _patch_mean(k.var1, filter_shape, strides) + b2,
                           var2=w2 * _patch_mean(k.var2, filter_shape, strides) + b2)

    return Layer(kfn)


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


def Relu() -> Layer:
    def kfn(k: KernelState) -> KernelState:
        nngp = _relu_t(k.nngp, *_outer(k))
        return KernelState(nngp=nngp, var1=k.var1 / 2.0, var2=k.var2 / 2.0)

    return Layer(kfn)


def _erf_t(nngp, v1, v2):
    """Arcsin kernel T(K) = E[erf(u) erf(v)] = (2/pi) asin(2K / sqrt((1+2v1)(1+2v2)))."""
    denom = torch.sqrt((1.0 + 2.0 * v1) * (1.0 + 2.0 * v2))
    return (2.0 / math.pi) * torch.asin(torch.clamp(2.0 * nngp / denom, -1.0, 1.0))


def Erf() -> Layer:
    def kfn(k: KernelState) -> KernelState:
        nngp = _erf_t(k.nngp, *_outer(k))
        return KernelState(nngp=nngp, var1=_erf_t(k.var1, k.var1, k.var1),
                           var2=_erf_t(k.var2, k.var2, k.var2))

    return Layer(kfn)


def Flatten() -> Layer:
    """Spatial mean readout (exact for Flatten -> Dense; stax.Flatten
    analogue); a no-op on a flat state."""

    def kfn(k: KernelState) -> KernelState:
        if not k.spatial:
            return k
        return KernelState(nngp=torch.mean(k.nngp, dim=(-2, -1)),
                           var1=torch.mean(k.var1, dim=(-2, -1)),
                           var2=torch.mean(k.var2, dim=(-2, -1)))

    return Layer(kfn)


def Identity() -> Layer:
    return Layer(lambda k: k)


def FanOut(n: int) -> Layer:
    return Layer(lambda k: tuple(k for _ in range(n)))


def FanInSum() -> Layer:
    """Sum of parallel branches: branch outputs have zero cross-covariance
    (each weighted branch ends in an independent zero-mean affine layer),
    so kernels add."""

    def kfn(ks):
        return KernelState(nngp=sum(k.nngp for k in ks),
                           var1=sum(k.var1 for k in ks),
                           var2=sum(k.var2 for k in ks))

    return Layer(kfn)


def serial(*layers: Layer) -> Layer:
    def kfn(k):
        for layer in layers:
            k = layer.kfn(k)
        return k

    return Layer(kfn)


def parallel(*layers: Layer) -> Layer:
    def kfn(ks):
        return tuple(layer.kfn(k) for layer, k in zip(layers, ks))

    return Layer(kfn)


def kernel_fn_of(layer: Layer):
    """Turn a composed Layer into ``kernel_fn(x1, x2=None, get="nngp")``."""

    def kernel_fn(x1, x2=None, get="nngp"):
        if get != "nngp":
            raise NotImplementedError(f"get={get!r}: only the NNGP is ported")
        return layer.kfn(input_state(x1, x2)).nngp

    return kernel_fn
