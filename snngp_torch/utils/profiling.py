"""Per-phase wall-clock counters (counterpart of ``Profiler`` in
``snngp/utils/profiling.py``), for ``reg tr -prof`` and the ML-II step
breakdown.

``phase`` waits for the card before and after its block, so each phase owns
its interval: ``torch.cuda.synchronize()`` where the JAX package fetches a
scalar. A process that never touched CUDA (a CPU run) does not sync.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["Profiler"]


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    """Accumulating per-phase wall-clock counters.

    >>> prof = Profiler()
    >>> with prof.phase("gram"):
    ...     k = kernel_fn(x, x)          # synchronized on exit
    >>> prof.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        _sync()  # drain prior work so the phase owns its interval
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase                 total_s     calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<20} {t:9.4f} {c:9d} {1e3 * t / c:9.2f}")
        return "\n".join(lines)
