"""Kernel state flowing through the NNGP layer recursion (counterpart of
``snngp/nn/state.py``, dense inputs only).

For dense inputs ``[N, D]`` the state is the ``[N1, N2]`` covariance plus
the two ``[N]`` diagonals. The image (matched-pixel) tier and the NTK field
land with the convolutional slice; ``ntk`` is carried as ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["KernelState", "input_state"]


@dataclasses.dataclass(frozen=True)
class KernelState:
    """nngp: [N1, N2] covariance; var1: [N1] and var2: [N2] diagonals;
    ntk: always None in this tier."""

    nngp: torch.Tensor
    var1: torch.Tensor
    var2: torch.Tensor
    ntk: Optional[torch.Tensor] = None


def input_state(x1: torch.Tensor, x2: Optional[torch.Tensor]) -> KernelState:
    """Layer-0 state: the per-feature second moment ``x1 . x2 / D`` (the NTK
    parameterization of ``stax.Dense``)."""
    if x2 is None:
        x2 = x1
    if x1.ndim != 2:
        raise ValueError(f"inputs must be [N, D] (the image tier is not "
                         f"ported yet); got {tuple(x1.shape)}")
    d = x1.shape[-1]
    nngp = (x1 @ x2.T) / d
    var1 = torch.sum(x1 * x1, dim=-1) / d
    var2 = torch.sum(x2 * x2, dim=-1) / d
    return KernelState(nngp=nngp, var1=var1, var2=var2)
