"""Checkpoints in the JAX package's .npz named-variable layout (counterpart
of ``snngp/utils/checkpoint.py``).

``save_params`` writes ``{"names": [...], "0": leaf0, "1": leaf1, ...}`` with
the raw (unconstrained) parameters, the layout the reference's test
subcommands restore from by *name suffix*. Files written by either package
load in the other.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np
import torch

from snngp_torch.models.params import named_leaves

__all__ = ["save_params", "load_named", "Checkpointer"]


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_params(path: str, params) -> None:
    """``params``: an ``nn.Module`` (its parameters) or a nested dict."""
    leaves = named_leaves(params)
    payload = {"names": np.array([n for n, _ in leaves])}
    for i, (_, v) in enumerate(leaves):
        payload[str(i)] = _to_numpy(v)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def load_named(path: str) -> Dict[str, np.ndarray]:
    """Load a checkpoint as {dotted_name: value}."""
    with np.load(path, allow_pickle=False) as data:
        names = [str(n) for n in data["names"]]
        return {name: data[str(i)] for i, name in enumerate(names)}


class Checkpointer:
    """Checkpoint file naming; the best-loss-gated save lands with training."""

    FILE_MATCH: str = "*.npz"
    FILE_FORMAT: str = "{:03d}.npz"

    @classmethod
    def list_indices(cls, logdir: str):
        """Sorted integer indices of checkpoint files in ``logdir``.

        Only numeric-stem ``.npz`` files count — the directory may also hold
        non-checkpoint artifacts (e.g. a ``fitted.npz`` serving cache).
        """
        out = []
        for path in glob.glob(os.path.join(logdir, cls.FILE_MATCH)):
            stem = os.path.basename(path).rsplit(".", 1)[0]
            if stem.isdigit():
                out.append(int(stem))
        return sorted(out)
