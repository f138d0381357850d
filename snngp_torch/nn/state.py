"""Kernel state flowing through the NNGP layer recursion (counterpart of
``snngp/nn/state.py``).

- dense inputs  ``[N, D]``:        ``nngp`` ``[N1, N2]``,       ``var`` ``[N]``;
- image inputs  ``[N, H, W, C]``:  ``nngp`` ``[N1, N2, H, W]``, ``var`` ``[N, H, W]``.

``nngp[i, j, h, w]`` is the covariance of the pre-activations of inputs i
and j at the same pixel (the matched-pixel, "diagonal spatial" tier): convs
with i.i.d. weights couple only equal filter offsets across the two inputs,
so the recursion closes on this diagonal, and a Flatten + Dense readout is
exact on it. ``ntk`` carries the Neural Tangent Kernel through the same
recursion when it is asked for (the paper-figure example's trained panels).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["KernelState", "input_state"]


@dataclasses.dataclass(frozen=True)
class KernelState:
    """nngp: [N1, N2] or [N1, N2, H, W]; var1: [N1] or [N1, H, W]; var2:
    [N2] or [N2, H, W]; ntk: shaped like nngp, or None when not asked for."""

    nngp: torch.Tensor
    var1: torch.Tensor
    var2: torch.Tensor
    ntk: Optional[torch.Tensor] = None

    @property
    def spatial(self) -> bool:
        return self.nngp.ndim == 4


def input_state(x1: torch.Tensor, x2: Optional[torch.Tensor], *,
                ntk: bool = False) -> KernelState:
    """Layer-0 state: the per-feature second moment ``x1 . x2 / D`` (for
    images, the channel mean at each matched pixel), the NTK
    parameterization of ``stax.Dense`` / ``stax.Conv``; with ``ntk`` the
    NTK starts at zeros shaped like ``nngp``."""
    if x2 is None:
        x2 = x1
    if x1.ndim == 2:
        d = x1.shape[-1]
        nngp = (x1 @ x2.T) / d
        var1 = torch.sum(x1 * x1, dim=-1) / d
        var2 = torch.sum(x2 * x2, dim=-1) / d
    elif x1.ndim == 4:
        nngp = torch.einsum("ihwc,jhwc->ijhw", x1, x2) / x1.shape[-1]
        var1 = torch.mean(x1 * x1, dim=-1)
        var2 = torch.mean(x2 * x2, dim=-1)
    else:
        raise ValueError(f"inputs must be [N, D] or [N, H, W, C]; got {tuple(x1.shape)}")
    return KernelState(nngp=nngp, var1=var1, var2=var2,
                       ntk=torch.zeros_like(nngp) if ntk else None)
