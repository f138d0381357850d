"""Finite-width networks of the layer tier as torch modules, and their
parameters across the two packages.

A composed :class:`~snngp_torch.nn.layers.Layer` has ``init`` / ``apply``
over params that are nested tuples of tensors in the JAX pytree's structure
and layouts. :class:`FiniteNet` holds such params as named parameters, so
that the objax-exact optimizers of :mod:`snngp_torch.utils.optim` (which
take a module) step them. :func:`params_from_jax` and
:func:`params_to_numpy` carry params across: nested tuples of numpy arrays
(what ``jax.device_get`` gives for a JAX params pytree, and what the
ensemble's checkpoints hold) in, nested tuples of tensors out, and back.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["FiniteNet", "params_from_jax", "params_to_numpy"]


def _is_node(tree) -> bool:
    # An object ndarray is a tuple that an old recursing np.array save mangled.
    return isinstance(tree, (tuple, list)) or (isinstance(tree, np.ndarray)
                                               and tree.dtype == object)


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """(path, leaf) pairs in the pytree's leaf order."""
    if _is_node(tree):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (i,))
    else:
        yield path, tree


def _map(fn, tree):
    """The same nested tuples with ``fn`` applied to every leaf."""
    if _is_node(tree):
        return tuple(_map(fn, sub) for sub in tree)
    return fn(tree)


def params_from_jax(tree, device=None):
    """Nested tuples of numpy arrays -> the same tuples of tensors on
    ``device``, copied, dtypes kept."""
    return _map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def params_to_numpy(params):
    """Nested tuples of tensors -> the same tuples of host numpy arrays
    (copies), as ``jax.device_get`` gives a JAX params pytree."""
    return _map(lambda t: t.detach().cpu().numpy().copy(), params)


class FiniteNet(nn.Module):
    """``layer.apply(params, x)`` as a module. Each leaf of ``params`` is a
    parameter named by its path (``p000_001`` is ``params[0][1]``); sorted
    names are the pytree's leaf order, the order the optimizers keep. The
    leaves are wrapped, not copied."""

    def __init__(self, layer, params):
        super().__init__()
        self.layer = layer
        self._skeleton = _map(lambda leaf: None, params)
        for path, leaf in _leaves(params):
            self.register_parameter(self._name(path), nn.Parameter(leaf))

    @staticmethod
    def _name(path) -> str:
        return "p" + "_".join(f"{i:03d}" for i in path)

    def params(self):
        """The parameters as nested tuples, in ``init``'s structure."""
        named = dict(self.named_parameters())
        leaves = iter(named[self._name(path)] for path, _ in _leaves(self._skeleton))
        return _map(lambda _: next(leaves), self._skeleton)

    def forward(self, x):
        return self.layer.apply(self.params(), x)
