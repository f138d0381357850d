"""Training-loop utilities (counterpart of ``snngp/utils/training.py``):

- :func:`train_step`: one ML-II step (loss, its gradient, one update);
- :class:`ReduceLROnPlateau`: plateau decay with the reference's exact
  is-better thresholds;
- :class:`Logger`: line-oriented file + stdout logger;
- ``get_context_summary``: the args dump.

The numpy ``DataLoader`` comes with the classification slice.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["train_step", "ReduceLROnPlateau", "Logger", "get_context_summary"]


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
