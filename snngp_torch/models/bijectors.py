"""Bijectors constraining trainable hyperparameters to be positive
(counterpart of ``snngp/models/bijectors.py``).

Parameters are *stored* unconstrained and *read* through the bijector; the
softplus inverse ``log(expm1(x))`` is guarded to the identity for x >= 20,
where ``expm1`` overflows and softplus(x) == x in fp32.
"""

from __future__ import annotations

import abc
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["Bijector", "PositiveBijector", "Exp", "Softplus", "positive", "triangular",
           "DEFAULT_POSITIVE_MINIMUM", "DEFAULT_POSITIVE_BIJECTOR"]

DEFAULT_POSITIVE_MINIMUM = 0.0
DEFAULT_POSITIVE_BIJECTOR = "softplus"


class Bijector(abc.ABC):
    @abc.abstractmethod
    def __call__(self, x):
        ...

    @abc.abstractmethod
    def inverse(self, x):
        ...


class PositiveBijector(Bijector):
    """``lower + base(x)``, with its inverse ``base^-1(y - lower)``."""

    def __init__(self, lower: float = 0.0):
        self.lower = lower

    def __call__(self, x):
        return self.lower + self._base(x)

    def inverse(self, x):
        return self._base_inv(x - self.lower)


class Exp(PositiveBijector):
    def _base(self, x):
        return torch.exp(x)

    def _base_inv(self, x):
        return torch.log(x)


class Softplus(PositiveBijector):
    def _base(self, x):
        # Above F.softplus's threshold of 20 it returns x, which is what
        # log(1 + exp(x)) rounds to in fp32 there.
        return F.softplus(x)

    def _base_inv(self, x):
        # log(expm1(x)) overflows for large x; softplus(x) ~ x for x >= 20.
        small = x < 20.0
        return torch.where(small, torch.log(torch.expm1(torch.where(small, x, 1.0))), x)


def positive(lower: Optional[float] = None, base: Optional[str] = None) -> PositiveBijector:
    """The positive bijector ``base`` ("softplus" by default, or "exp") with
    the lower bound ``lower`` (0 by default)."""
    lower_bound = lower if lower is not None else DEFAULT_POSITIVE_MINIMUM
    name = (base if base is not None else DEFAULT_POSITIVE_BIJECTOR).lower()
    if name == "exp":
        return Exp(lower_bound)
    if name == "softplus":
        return Softplus(lower_bound)
    raise KeyError(f"Unsupported bijector '{name}'")


def triangular():
    raise NotImplementedError
