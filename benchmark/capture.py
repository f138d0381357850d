"""One ``torch.profiler`` capture of a stretch of the window, reduced to what
the per-layer readers need: the device's kernels and copies, the span of
the benchmark's own ``bench.*`` ranges, and the host's activity during the
device's idle gaps.

The capture has to hold every kernel the program launched in it: where it
holds fewer of the port's kernels than the port's launch counters say were
launched, torch.profiler lost records (the port's PERF.md, section 7) and
the run fails rather than report a share of a partial trace. The events
are read once the window has closed (``Pending.reduce``), so that their
parsing takes none of the window's time.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from benchmark.counts import kernel_key


class Capture:
    def __init__(self, device_ops, host_ops, units):
        self.device_ops = device_ops    # [(name, start_us, end_us)]: kernels, copies, fills
        self.host_ops = [op for op in host_ops if op[0] != "Activity Buffer Request"]
        start = min(s for s, _ in units)
        end = max([e for _, e in units] + [e for _, _, e in device_ops])
        self.span_us = (start, end)
        self.intervals = _union([(max(s, start), min(e, end)) for _, s, e in device_ops
                                 if e > start and s < end])

    @property
    def window_s(self):
        return (self.span_us[1] - self.span_us[0]) * 1e-6

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.intervals) * 1e-6

    def kernels(self, key):
        """Device seconds and count of the kernels of one work key."""
        times = [(e - s) * 1e-6 for n, s, e in self.device_ops if kernel_key(n) == key]
        return sum(times), len(times)

    def top_ops(self, k=10):
        total = defaultdict(float)
        for name, s, e in self.device_ops:
            total[_short(name)] += (e - s) * 1e-6
        return sorted(([n, t] for n, t in total.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10):
        """The longest idle gaps of the device within the span, each named by
        the innermost host operation running at its middle."""
        gaps = []
        edges = [self.span_us[0]] + [x for iv in self.intervals for x in iv] + [self.span_us[1]]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                gaps.append((s, e))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = 0.5 * (s + e)
            inside = [(he - hs, n) for n, hs, he in self.host_ops
                      if hs <= mid <= he and not n.startswith("bench.")]
            if inside:
                label = min(inside)[1]
            else:   # the host ran Python between operations: name the last one
                before = [(he, n) for n, hs, he in self.host_ops
                          if he <= mid and not n.startswith("bench.")]
                label = f"python after {max(before)[1]}" if before else "python"
            out.append([label, (e - s) * 1e-6])
        return out


def _short(name, limit=96):
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= limit else name[:limit]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


class Pending:
    """A finished capture whose events are not read yet."""

    def __init__(self, prof, launched):
        self.prof = prof
        self.launched = launched      # work key -> the program's launches inside

    def reduce(self):
        device_ops, host_ops, units = [], [], []
        for e in self.prof.events():
            span = (e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.name.startswith("bench."):     # the ranges' own device-side marks
                    device_ops.append((e.name, *span))
            else:
                host_ops.append((e.name, *span))
                if e.name.startswith("bench."):
                    units.append(span)
        cap = Capture(device_ops, host_ops, units)
        for key, want in self.launched.items():
            got = cap.kernels(key)[1]
            if got < want:
                raise RuntimeError(f"the capture holds {got} {key} kernels of the {want} "
                                   "launched: torch.profiler lost kernel records")
        return cap


def capture(fn, launches):
    """Run ``fn`` under one profiler capture; ``launches()`` reads the
    program's launch counters (work key -> count) before and after."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before = launches()
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    after = launches()
    return Pending(prof, {key: after[key] - before[key] for key in after})
