"""The positive bijector constraining trainable hyperparameters
(counterpart of ``snngp/models/bijectors.py``; the port needs softplus only).

Parameters are *stored* unconstrained and *read* through the bijector; the
softplus inverse ``log(expm1(x))`` is guarded to the identity for x >= 20,
where ``expm1`` overflows and softplus(x) == x in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["Softplus", "positive"]


class Softplus:
    def __init__(self, lower: float = 0.0):
        self.lower = lower

    def __call__(self, x):
        # Above F.softplus's threshold of 20 it returns x, which is what
        # log(1 + exp(x)) rounds to in fp32 there.
        return self.lower + F.softplus(x)

    def inverse(self, x):
        x = x - self.lower
        # log(expm1(x)) overflows for large x; softplus(x) ~ x for x >= 20.
        small = x < 20.0
        return torch.where(small, torch.log(torch.expm1(torch.where(small, x, 1.0))), x)


def positive(lower: Optional[float] = None) -> Softplus:
    return Softplus(0.0 if lower is None else lower)
