"""Per-phase wall-clock counters (counterpart of ``Profiler`` in
``snngp/utils/profiling.py``), for ``reg tr -prof`` and the ML-II step
breakdown, and :func:`trace`, a ``torch.profiler`` capture of a block.

``phase`` waits for the card before and after its block, so each phase owns
its interval: ``torch.cuda.synchronize()`` where the JAX package fetches a
scalar. A process that never touched CUDA (a CPU run) does not sync.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

__all__ = ["Profiler", "trace"]


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


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """A ``torch.profiler`` capture around a block, written under ``logdir``
    (default ``snngp-trace`` in the temporary directory) as a Chrome trace
    (``trace-<pid>-<n>.json``, viewable in Perfetto or chrome://tracing),
    and ``logdir`` yielded, as the JAX package's ``jax.profiler`` capture
    does. It records the CPU, and the card's kernels when CUDA is
    initialized; a block that first touches CUDA is traced on the CPU
    only. ``torch.profiler`` can lose the card's kernel records of a
    capture (on torch 2.x with CUPTI: a few, or all of a short capture's,
    when captures come seconds apart; ``tools/trace_repro.py --case idle``
    shows it in a process that imports only torch); when the capture holds
    fewer kernels than kernel launches, ``trace`` warns
    (``RuntimeWarning``) that the trace lacks device time."""
    import tempfile
    import warnings

    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "snngp-trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        _sync()
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace-{os.getpid()}-")])
    path = os.path.join(logdir, f"trace-{os.getpid()}-{n}.json")
    prof.export_chrome_trace(path)
    if ProfilerActivity.CUDA in activities:
        kernels, launches = kernel_records(prof.events())
        if kernels < launches:
            warnings.warn(f"{path}: torch.profiler recorded {kernels} kernels for the "
                          f"block's {launches} kernel launches; the trace lacks their "
                          "device time", RuntimeWarning, stacklevel=3)


def kernel_records(events):
    """(kernels, kernel launches) among a capture's events: the card's
    events other than copies and fills, and the host's launch calls."""
    kernels = launches = 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += not e.name.startswith(("Memcpy", "Memset"))
        elif "LaunchKernel" in e.name:
            launches += 1
    return kernels, launches
