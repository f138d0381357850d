"""Training-loop utilities (counterpart of ``snngp/utils/training.py``):

- :func:`train_step`: one ML-II step (loss, its gradient, one update);
- :func:`svsp_train_step`: one ELBO step of a sparse variational model;
- :class:`DataLoader`: in-memory numpy batcher with the reference's seeded
  per-epoch reshuffle (a copy of the JAX package's: the same seed gives the
  same batches);
- :class:`ReduceLROnPlateau`: plateau decay with the reference's exact
  is-better thresholds;
- :class:`Logger`: line-oriented file + stdout logger;
- :func:`progress`: a tqdm progress bar where tqdm is installed;
- ``get_context_summary``: the args dump.
"""

from __future__ import annotations

import contextlib
import math
import os
import random as _pyrandom
from typing import Optional

import numpy as np

__all__ = ["train_step", "svsp_train_step", "DataLoader", "ReduceLROnPlateau",
           "Logger", "progress", "get_context_summary"]


def train_step(model, optimizer, lr, prof=None):
    """One ML-II step on ``model`` (an ``SPR``): the marginal NLL / N, its
    gradient, one optimizer update. Returns the loss, detached and left on
    its device (reading it is the caller's host sync).

    With a :class:`~snngp_torch.utils.profiling.Profiler` the step runs in
    four synchronized phases: ``gram`` (the train Gram, K1 on the card),
    ``cholesky+solves`` (the marginal likelihood from it), ``backward``
    (autograd, K2 on the card) and ``optimizer``."""
    phase = prof.phase if prof is not None else (lambda name: contextlib.nullcontext())
    optimizer.zero_grad()
    with phase("gram"):
        gram = model._gram(model.kernel.get_kernel_fn())
    with phase("cholesky+solves"):
        loss = model.loss(gram)
    with phase("backward"):
        loss.backward()
    with phase("optimizer"):
        optimizer.update(lr)
    return loss.detach()


def svsp_train_step(model, optimizers, lrs, x_batch, y_batch, num_train, num_samples,
                    generator=None, prof=None, mesh=None):
    """One ELBO step on ``model`` (an ``SVSP``): the negative ELBO per data
    point, its gradient, one update of each optimizer at its learning rate
    (``-lr2`` trains with two: every parameter but the prior's at ``lrs[0]``,
    the prior's at ``lrs[1]``). Returns the loss, detached and left on its
    device.

    With a :class:`~snngp_torch.utils.profiling.Profiler` the step runs in
    five synchronized phases: ``gram`` (the three Gram blocks, K3 on the
    card), ``posterior`` (the inducing inverses, the eigh pseudo-inverse and
    the safety lifts), ``sampling+likelihood`` (the posterior draws, the
    softmax likelihood and the KL), ``backward`` and ``optimizer``.

    ``mesh`` shards the batch's Gram blocks over its shards
    (``SVSP.loss(..., mesh=)``); the caller passes it only for a batch
    whose size the mesh divides."""
    phase = prof.phase if prof is not None else (lambda name: contextlib.nullcontext())
    for opt in optimizers:
        opt.zero_grad()
    loss = model.loss(x_batch, y_batch, num_train, num_samples, generator=generator,
                      phase=phase, mesh=mesh)
    with phase("backward"):
        loss.backward()
    with phase("optimizer"):
        for opt, lr in zip(optimizers, lrs):
            opt.update(lr)
    return loss.detach()


class DataLoader:
    """Batches of (x, y) numpy arrays; with ``shuffle`` each epoch's order is
    ``random.Random(seed + epoch).shuffle`` (the seed is incremented at each
    iteration, as the reference does); ``batch_size=None`` without shuffle
    yields the whole set once."""

    def __init__(self, x, y, batch_size: Optional[int] = None, *,
                 shuffle: bool = False, seed: int = 0):
        self.shuffle = shuffle
        self.seed = seed
        self.x = np.array(x)
        self.y = np.array(y)
        self.indices = list(range(self.x.shape[0]))
        self.batch_size = self.x.shape[0] if batch_size is None else batch_size
        self.not_use_indices = (batch_size is None and not shuffle)
        self._batch_indices = None
        self._batch_idx = None

    def __iter__(self):
        if self.shuffle:
            self.seed += 1
            indices = self.indices.copy()
            _pyrandom.Random(self.seed).shuffle(indices)
        else:
            indices = self.indices
        self._batch_idx = 0
        if not self.not_use_indices:
            self._batch_indices = [indices[i: i + self.batch_size]
                                   for i in range(0, len(indices), self.batch_size)]
        return self

    def __next__(self):
        if self.not_use_indices:
            if self._batch_idx > 0:
                raise StopIteration
            self._batch_idx += 1
            return self.x, self.y
        if self._batch_idx >= len(self._batch_indices):
            raise StopIteration
        idx = self._batch_indices[self._batch_idx]
        self._batch_idx += 1
        return self.x[idx], self.y[idx]

    def __len__(self):
        return math.ceil(len(self.indices) / self.batch_size)

    @property
    def num_data(self):
        return self.x.shape[0]


class ReduceLROnPlateau:
    """Plateau LR decay with the reference's exact is-better thresholds."""

    def __init__(self, lr, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", min_lr=0, eps=1e-8):
        if mode not in {"min", "max"}:
            raise ValueError(f"mode {mode} is unknown")
        if threshold_mode not in {"rel", "abs"}:
            raise ValueError(f"threshold mode {threshold_mode} is unknown")
        self.lr = lr
        self.factor = factor
        self.min_lr = min_lr
        self.patience = patience
        self.mode = mode
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.eps = eps
        self.last_epoch = 0
        self.mode_worse = float("inf") if mode == "min" else -float("inf")
        self.best = self.mode_worse
        self.num_bad_epochs = 0

    def step(self, metrics) -> bool:
        current = float(metrics)
        self.last_epoch += 1
        reduced = False
        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self._reduce_lr()
            self.num_bad_epochs = 0
            reduced = True
        return reduced

    def _reduce_lr(self):
        new_lr = max(self.lr * self.factor, self.min_lr)
        if self.lr - new_lr > self.eps:
            self.lr = new_lr

    def is_better(self, a, best):
        if self.mode == "min" and self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        if self.mode == "min":
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold


class Logger:
    def __init__(self, logdir: str, filename: str = "train.log",
                 makedir: bool = True, quite: bool = False):
        self.logdir = logdir
        self.quite = quite
        if makedir:
            os.makedirs(logdir, exist_ok=True)
        self.logfile = open(os.path.join(logdir, filename), "w")

    def log(self, *args, is_tqdm: bool = False):
        s = "".join(map(str, args))
        self.logfile.write(s + "\n")
        self.logfile.flush()
        if not self.quite:
            if is_tqdm:
                try:
                    from tqdm import tqdm
                    tqdm.write(s)
                except ImportError:
                    print(s, flush=True)
            else:
                print(s, flush=True)

    def close(self):
        self.logfile.close()


def progress(it, quite, **kw):
    """``it`` under a tqdm bar (``kw`` its options) where tqdm is installed."""
    try:
        from tqdm import tqdm
    except ImportError:
        return it
    return tqdm(it, ncols=0, disable=quite, **kw)


def get_context_summary(args, values_dict, indent=2):
    args_dict = {k: v for k, v in vars(args).items() if k != "func"}
    keys = list(args_dict.keys()) + list(values_dict.keys())
    key_max_len = max(map(len, keys)) if keys else 0
    s = "Args:\n"
    for k, v in args_dict.items():
        s += f"{' ' * indent}{k.ljust(key_max_len)}: {v}\n"
    s += "\nValues:\n"
    for k, v in values_dict.items():
        s += f"{' ' * indent}{k.ljust(key_max_len)}: {v}\n"
    return s + "\n"
