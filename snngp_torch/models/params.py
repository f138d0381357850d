"""Parameter helpers (counterpart of ``snngp/models/params.py``).

The JAX package threads parameters as nested dicts of *unconstrained*
arrays; the port keeps them as ``nn.Parameter``s of the model modules, laid
out so that ``SPR.named_parameters()`` yields exactly the JAX package's
dotted names (``eps``, ``kernel.b_std``, ``kernel.last_w_std``,
``kernel.w_std``, ``likelihood.a``, ``likelihood.b``). A JAX checkpoint is
then one ``load_state_dict(from_jax_named(named))``.

A constrained parameter stores ``bijector.inverse(value)`` and is read back
through the bijector (the reference's ``safe_value`` semantics).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from snngp_torch.models.bijectors import PositiveBijector

__all__ = [
    "constrained_init",
    "constrained_read",
    "named_leaves",
    "get_by_suffix",
    "assign_by_suffix",
    "from_jax_named",
    "unflatten_named",
]


def constrained_init(value, bijector: PositiveBijector) -> nn.Parameter:
    """A positive-constrained parameter stored as its unconstrained preimage."""
    return nn.Parameter(bijector.inverse(torch.as_tensor(value, dtype=torch.float32)))


def constrained_read(raw: torch.Tensor, bijector: PositiveBijector) -> torch.Tensor:
    """The reference's ``safe_value``: read through the bijector."""
    return bijector(raw)


def _walk(tree: Any, prefix: str, out: List[Tuple[str, Any]]):
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            _walk(tree[k], f"{prefix}.{k}" if prefix else k, out)
    else:
        out.append((prefix, tree))


def named_leaves(params) -> List[Tuple[str, Any]]:
    """Deterministic (name, leaf) pairs with dotted paths, sorted by name as
    the JAX package's dict walk sorts them. ``params`` is an ``nn.Module``
    (its parameters) or a nested dict."""
    if isinstance(params, nn.Module):
        return sorted(params.named_parameters(), key=lambda kv: kv[0])
    out: List[Tuple[str, Any]] = []
    _walk(params, "", out)
    return out


def unflatten_named(named: Dict[str, Any]) -> Dict[str, Any]:
    """Rebuild a nested dict from dotted names (the inverse of
    :func:`named_leaves` for dict-only trees)."""
    root: Dict[str, Any] = {}
    for name, value in named.items():
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def get_by_suffix(named: Dict[str, Any], key: str) -> Optional[Any]:
    """Reference restore convention: match a stored name by its last dotted
    component (``regression/test.py:38-43``)."""
    for name, value in named.items():
        if name.split(".")[-1] == key:
            return value
    return None


def assign_by_suffix(module: nn.Module, key: str, value) -> bool:
    """Copy ``value`` into every parameter of ``module`` whose dotted name
    ends in ``key``."""
    hit = False
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.split(".")[-1] == key:
                p.copy_(torch.as_tensor(np.asarray(value), dtype=p.dtype))
                hit = True
    return hit


def from_jax_named(named: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's raw (unconstrained) parameters — a JAX parameter
    dict (nested, as ``SVSP.init_params`` returns it) or its dotted names —
    as a state dict for the port's modules (``model.load_state_dict(...)``)."""
    return {name: torch.as_tensor(np.array(v), dtype=torch.float32)
            for name, v in named_leaves(named)}
