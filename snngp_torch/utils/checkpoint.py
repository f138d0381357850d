"""Checkpoints in the JAX package's .npz named-variable layout (counterpart
of ``snngp/utils/checkpoint.py``).

``save_params`` writes ``{"names": [...], "0": leaf0, "1": leaf1, ...}`` with
the raw (unconstrained) parameters, the layout the reference's test
subcommands restore from by *name suffix*. :class:`Checkpointer` keeps the
best-loss-gated save and the keep-last-k pruning of the reference.

``save_training_state`` / ``load_training_state`` write and read
``resume.state`` in the JAX package's layout: ``p{i}`` the parameters in
sorted-name order, ``o{i}`` the optimizers' state leaves, one optimizer
after the other (Adam: ``step``, then ``mu``, then ``nu``, each in
sorted-name order; ``cls tr -lr2`` trains with two), ``meta_*`` the loop
state. Files written by either package load in the other.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np
import torch

from snngp_torch.models.params import named_leaves

__all__ = ["save_params", "load_named", "Checkpointer", "save_training_state",
           "load_training_state"]


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
    """Best-loss-gated ``NNN.npz`` saves, keeping the last ``keep_ckpts``."""

    FILE_MATCH: str = "*.npz"
    FILE_FORMAT: str = "{:03d}.npz"

    def __init__(self, logdir: str, keep_ckpts: int = 10, makedir: bool = True):
        self.logdir = logdir
        self.keep_ckpts = keep_ckpts
        if makedir:
            os.makedirs(logdir, exist_ok=True)
        self.best_loss = float("inf")

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

    def save(self, idx: int, params) -> None:
        save_params(os.path.join(self.logdir, self.FILE_FORMAT.format(idx)), params)
        for old in self.list_indices(self.logdir)[:-self.keep_ckpts]:
            os.remove(os.path.join(self.logdir, self.FILE_FORMAT.format(old)))

    def step(self, idx: int, loss: float, params) -> bool:
        if loss < self.best_loss:
            self.best_loss = loss
            self.save(idx, params)
            return True
        return False


def _optimizers(optimizer):
    return list(optimizer) if isinstance(optimizer, (list, tuple)) else [optimizer]


def save_training_state(path: str, model, optimizer, meta: Dict) -> None:
    """Write the parameters, the state of the optimizer (or of a list of
    them) and the loop metadata to one .npz (atomically: a temporary file,
    then a rename)."""
    p_leaves = [v for _, v in named_leaves(model)]
    o_leaves = [leaf for opt in _optimizers(optimizer) for leaf in opt.state_leaves()]
    payload: Dict[str, np.ndarray] = {"num_params": np.array(len(p_leaves)),
                                      "num_opt": np.array(len(o_leaves))}
    for i, leaf in enumerate(p_leaves):
        payload[f"p{i}"] = _to_numpy(leaf)
    for i, leaf in enumerate(o_leaves):
        payload[f"o{i}"] = _to_numpy(leaf)
    for k, v in meta.items():
        payload[f"meta_{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_training_state(path: str, model, optimizer) -> Dict[str, np.ndarray]:
    """Load the parameters into ``model`` and the state into ``optimizer``
    (or a list of them, in the order they were saved); return the loop
    metadata."""
    with np.load(path) as data:
        params = [p for _, p in named_leaves(model)]
        n_p, n_o = int(data["num_params"]), int(data["num_opt"])
        if n_p != len(params):
            raise ValueError(f"{path} holds {n_p} parameters; the model has {len(params)}")
        with torch.no_grad():
            for i, p in enumerate(params):
                p.copy_(torch.as_tensor(data[f"p{i}"], dtype=p.dtype))
        leaves = [data[f"o{i}"] for i in range(n_o)]
        opts = _optimizers(optimizer)
        sizes = [len(opt.state_leaves()) for opt in opts]
        if sum(sizes) != n_o:
            raise ValueError(f"{path} holds {n_o} optimizer leaves; the optimizers "
                             f"take {sum(sizes)}")
        start = 0
        for opt, size in zip(opts, sizes):
            opt.load_state_leaves(leaves[start:start + size])
            start += size
        return {k[5:]: data[k] for k in data.files if k.startswith("meta_")}
