"""Full spatial-covariance NNGP / NTK tier for pooled conv architectures
(counterpart of ``snngp/nn/full.py``).

The matched-pixel tier (:mod:`snngp_torch.nn.layers`) is exact only for
Flatten readouts. Average pooling mixes different pixels of one input, so
the recursion carries the full pixel-pair covariance:

    nngp: [N1, N2, H, W, H, W]   (p1 in input 1, p2 in input 2)
    cov1: [N1, H, W, H, W]       (same-input pixel-pair covariance)
    cov2: [N2, H, W, H, W]

Closed forms (i.i.d. filter taps couple only equal offsets):

- Conv:     K'[p1, p2] = w^2/F sum_d K[s p1 + d, s p2 + d] + b^2
- Act:      elementwise in (p1, p2), with the variances at the spatial diagonal
- AvgPool:  independent window means over p1 and p2
- GAP:      mean over all (p1, p2) -> [N1, N2]
- Flatten:  mean over the diagonal p1 == p2

This tier materializes 4 MB a pair at 32 x 32. It is the reference of the
fused Myrtle Gram (:mod:`snngp_torch.ops.myrtle_gram`) at small sizes, the
backward of that Gram's ``trainable_inputs=True`` contract (autograd through
these modules), and the route of ``get="ntk"`` and of the image shapes the
fused Gram does not take.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["FullKernelState", "full_input_state", "ConvF", "ActF", "AvgPoolF",
           "GlobalAvgPoolF", "FlattenF", "DenseF", "serial_f", "full_kernel_fn",
           "get_myrtle_kernel", "scan_tiled_gram"]


@dataclasses.dataclass(frozen=True)
class FullKernelState:
    nngp: torch.Tensor                  # [N1, N2, H, W, H, W] or [N1, N2] after readout
    cov1: torch.Tensor                  # [N1, H, W, H, W] or [N1]
    cov2: torch.Tensor                  # [N2, H, W, H, W] or [N2]
    ntk: Optional[torch.Tensor] = None

    @property
    def spatial(self) -> bool:
        return self.nngp.ndim == 6


def full_input_state(x1, x2=None, *, ntk: bool = False, dtype=None) -> FullKernelState:
    """The input moments of [N, H, W, C] images. ``dtype`` (e.g.
    ``torch.bfloat16``) casts the states after the fp32 contraction; the
    fused Gram's path does not take it."""
    if x2 is None:
        x2 = x1
    c = x1.shape[-1]
    nngp = torch.einsum("iabc,jdec->ijabde", x1, x2) / c
    cov1 = torch.einsum("iabc,idec->iabde", x1, x1) / c
    cov2 = torch.einsum("iabc,idec->iabde", x2, x2) / c
    if dtype is not None:
        nngp, cov1, cov2 = nngp.to(dtype), cov1.to(dtype), cov2.to(dtype)
    return FullKernelState(nngp, cov1, cov2, torch.zeros_like(nngp) if ntk else None)


def _same_pads(size: int, filt: int, stride: int):
    """lax SAME padding: (pad_low, pad_high, out_size)."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + filt - size, 0)
    return pad // 2, pad - pad // 2, out


def _conv_pair(k, filter_shape, strides):
    """Same-offset stencil mean over the last two spatial pairs:
    k [..., H, W, H, W] -> [..., H', W', H', W']."""
    fh, fw = filter_shape
    sh, sw = strides
    h, w = k.shape[-4], k.shape[-3]
    plh, phh, oh = _same_pads(h, fh, sh)
    plw, phw, ow = _same_pads(w, fw, sw)
    # F.pad lists pads from the last axis backwards.
    kp = F.pad(k, (plw, phw, plh, phh, plw, phw, plh, phh))
    acc = None
    for dh in range(fh):
        for dw in range(fw):
            sl = kp[..., dh:dh + sh * (oh - 1) + 1:sh, dw:dw + sw * (ow - 1) + 1:sw,
                    dh:dh + sh * (oh - 1) + 1:sh, dw:dw + sw * (ow - 1) + 1:sw]
            acc = sl if acc is None else acc + sl
    return acc / (fh * fw)


def ConvF(filter_shape=(3, 3), strides=(1, 1), w_std=1.0, b_std=0.0):
    def kfn(k: FullKernelState) -> FullKernelState:
        w2, b2 = w_std * w_std, b_std * b_std
        nngp = w2 * _conv_pair(k.nngp, filter_shape, strides) + b2
        cov1 = w2 * _conv_pair(k.cov1, filter_shape, strides) + b2
        cov2 = w2 * _conv_pair(k.cov2, filter_shape, strides) + b2
        ntk = None if k.ntk is None else nngp + w2 * _conv_pair(k.ntk, filter_shape, strides)
        return FullKernelState(nngp, cov1, cov2, ntk)

    return kfn


def _diag_var(cov):
    """[N, H, W, H, W] -> [N, H, W] spatial-diagonal variance."""
    return torch.einsum("nijij->nij", cov)


def ActF(act: str):
    """The dual activation on every state, and its derivative's expectation
    on the NTK: the layer tier's closed forms (``_relu_t`` carries the
    analytic derivatives, finite at c = +-1, which the same-input covariance
    meets on its spatial diagonal)."""
    from snngp_torch.nn.layers import _erf_t, _erf_tdot, _relu_t, _relu_tdot
    t_fn = {"relu": _relu_t, "erf": _erf_t}[act]
    td_fn = {"relu": _relu_tdot, "erf": _erf_tdot}[act]

    def kfn(k: FullKernelState) -> FullKernelState:
        v1 = _diag_var(k.cov1)
        v2 = _diag_var(k.cov2)
        b1 = v1[:, None, :, :, None, None]
        b2 = v2[None, :, None, None, :, :]
        nngp = t_fn(k.nngp, b1, b2)
        ntk = None if k.ntk is None else k.ntk * td_fn(k.nngp, b1, b2)
        cov1 = t_fn(k.cov1, v1[:, :, :, None, None], v1[:, None, None, :, :])
        cov2 = t_fn(k.cov2, v2[:, :, :, None, None], v2[:, None, None, :, :])
        return FullKernelState(nngp, cov1, cov2, ntk)

    return kfn


def _pool_axis_pair(k, window: int, offset: int):
    """Non-overlapping window mean over spatial axes (offset, offset + 1)."""
    shape = k.shape
    h, w = shape[offset], shape[offset + 1]
    if h % window or w % window:
        raise ValueError("AvgPool requires divisibility")
    new = shape[:offset] + (h // window, window, w // window, window) + shape[offset + 2:]
    return k.reshape(new).mean(dim=(offset + 1, offset + 3))


def AvgPoolF(window=(2, 2), strides=None):
    """Non-overlapping average pooling (window == strides, the Myrtle case)."""
    if strides is not None and tuple(strides) != tuple(window):
        raise NotImplementedError("only window == strides pooling")
    if window[0] != window[1]:
        raise NotImplementedError("square windows only")
    win = window[0]

    def pool_pairs(k, first):
        return _pool_axis_pair(_pool_axis_pair(k, win, first), win, first + 2)

    def kfn(k: FullKernelState) -> FullKernelState:
        return FullKernelState(pool_pairs(k.nngp, 2), pool_pairs(k.cov1, 1),
                               pool_pairs(k.cov2, 1),
                               None if k.ntk is None else pool_pairs(k.ntk, 2))

    return kfn


def GlobalAvgPoolF():
    def kfn(k: FullKernelState) -> FullKernelState:
        # The big spatial reduction accumulates in fp32 (bf16 states).
        f32 = lambda a: a.to(torch.float32) if a.dtype == torch.bfloat16 else a  # noqa: E731
        return FullKernelState(
            torch.mean(f32(k.nngp), dim=(2, 3, 4, 5)), torch.mean(f32(k.cov1), dim=(1, 2, 3, 4)),
            torch.mean(f32(k.cov2), dim=(1, 2, 3, 4)),
            None if k.ntk is None else torch.mean(f32(k.ntk), dim=(2, 3, 4, 5)))

    return kfn


def FlattenF():
    """Diagonal-pixel mean: consistent with the matched-pixel tier's Flatten."""

    def kfn(k: FullKernelState) -> FullKernelState:
        diag = lambda t: torch.einsum("mnijij->mnij", t).mean(dim=(2, 3))  # noqa: E731
        return FullKernelState(diag(k.nngp), _diag_var(k.cov1).mean(dim=(1, 2)),
                               _diag_var(k.cov2).mean(dim=(1, 2)),
                               None if k.ntk is None else diag(k.ntk))

    return kfn


def DenseF(w_std=1.0, b_std=0.0):
    def kfn(k: FullKernelState) -> FullKernelState:
        w2, b2 = w_std * w_std, b_std * b_std
        nngp = w2 * k.nngp + b2
        ntk = None if k.ntk is None else nngp + w2 * k.ntk
        return FullKernelState(nngp, w2 * k.cov1 + b2, w2 * k.cov2 + b2, ntk)

    return kfn


def serial_f(*kfns):
    def kfn(k):
        for f in kfns:
            k = f(k)
        return k

    return kfn


def full_kernel_fn(composed, dtype=None):
    def kernel_fn(x1, x2=None, get="nngp"):
        want = (get,) if isinstance(get, str) else tuple(get)
        state = composed(full_input_state(x1, x2, ntk="ntk" in want, dtype=dtype))
        outs = [state.nngp if g == "nngp" else state.ntk for g in want]
        return outs[0] if isinstance(get, str) else tuple(outs)

    return kernel_fn


def scan_tiled_gram(kernel_fn, x1, x2=None, *, tile: int = 16, chunk: int = 64,
                    remat: bool = False):
    """Assemble the N1 x N2 Gram from (tile, tile) blocks, one kernel_fn call
    a block, into a host numpy array. Symmetric inputs (``x2 is None``)
    compute only the upper-triangle blocks and mirror them.

    The JAX package batches ``chunk`` blocks into one ``lax.scan`` dispatch
    (and ``remat`` checkpoints each) to amortize the host latency of a
    remote device; PyTorch dispatches eagerly, so both are accepted and
    change nothing here."""
    del chunk, remat
    symmetric = x2 is None
    x2_eff = x1 if symmetric else x2
    n1, n2 = x1.shape[0], x2_eff.shape[0]
    if n1 % tile or n2 % tile:
        raise ValueError("pad inputs to the tile size")
    out = np.zeros((n1, n2), np.float32)
    with torch.no_grad():
        for i in range(0, n1, tile):
            for j in range(i if symmetric else 0, n2, tile):
                blk = kernel_fn(x1[i:i + tile], x2_eff[j:j + tile], get="nngp")
                blk = blk.detach().float().cpu().numpy()   # numpy has no bfloat16
                out[i:i + tile, j:j + tile] = blk
                if symmetric and j > i:
                    out[j:j + tile, i:i + tile] = blk.T
    return out


def get_myrtle_kernel(depth: int = 5, num_class: int = 1, act: str = "relu",
                      w_std=1.0, b_std=0.0, last_w_std=1.0, dtype=None):
    """Myrtle-family CNN kernel (Shankar et al. 2020) on this tier: conv /
    act stacks with 2 x 2 average pools, global average pool readout.
    ``depth`` in {5, 7, 10} selects 1/1/1, 2/2/1 or 3/3/2 convs per pooling
    group."""
    per_group = {5: (1, 1, 1), 7: (2, 2, 1), 10: (3, 3, 2)}[depth]

    def conv():
        return ConvF((3, 3), (1, 1), w_std, b_std)

    stack = [conv(), ActF(act)]
    for g, reps in enumerate(per_group):
        for _ in range(reps - 1 if g == 0 else reps):
            stack += [conv(), ActF(act)]
        stack += [AvgPoolF((2, 2))]
    stack += [GlobalAvgPoolF(), DenseF(last_w_std)]
    return full_kernel_fn(serial_f(*stack), dtype=dtype)
