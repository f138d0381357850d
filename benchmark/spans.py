"""The port's ``snngp.*`` spans (``snngp_torch.utils.profiling.span``) read
from a traced run's capture (``benchmark.capture.Capture``): the device time
of the kernels, copies and fills launched inside a span, and the device's
idle time while the host was inside one. Each reduction returns None where
the capture holds no span it reads (a program without spans), and the
harness then leaves the metric out of the line.

Launch to span: the spans open on the host, on any thread, when the op's
launch call (the CUDA API's launch, copy or fill call) started: a backward
runs on autograd's worker thread while the caller's thread waits inside
``backward()``, so a launch there sits in the worker's spans and in the
caller's. An op counts once under every span open at its launch.

Op to launch call: the capture keeps each event's name and interval, not
the profiler's correlation ids, so the i-th launch call is tied to the i-th
device op in start order. That is the card's own order: the port launches
all its work on the current stream, and the capture starts and ends with
nothing in flight. The pairing is checked: as many ops as calls, each pair
of the same kind (kernel, copy, fill). A capture that fails the check (a
lost record, a second stream) is read as holding nothing.

Two clocks: the card's times in a capture are offset from the host's by an
amount that changes from run to run (from about -0.69 ms to +0.003 ms on an
H100 with torch 2.11), so no op is compared with a host time as it stands.
The least of (op start - its call's start) over the capture, a launch onto
an idle card, is that offset plus the least launch latency (a few
microseconds): device times less it are host times.
"""

from __future__ import annotations

import weakref
from bisect import bisect_right

from benchmark.counts import kernel_key

PREFIX = "snngp."
_CACHE = weakref.WeakKeyDictionary()


def _call_kind(name):
    """The device op a CUDA API call on the host enqueues, or None."""
    if not name.startswith("cu"):
        return None
    if "LaunchKernel" in name:
        return "kernel"
    if "Memcpy" in name:
        return "copy"
    if "Memset" in name:
        return "fill"
    return None


def _op_kind(name):
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


class Spans:
    """The spans of one capture: each span's host intervals; each device op
    with the names of the spans open at its launch, and the card's clock
    less the host's (``ops`` and ``skew`` None where the ops do not pair
    with their calls)."""

    def __init__(self, cap):
        self.spans = sorted((s, e, n) for n, s, e in cap.host_ops
                            if n.startswith(PREFIX) and e > s)
        self.names = {n for _, _, n in self.spans}
        self._edges, self._open = _segments(self.spans)
        self.ops, self.skew = self._attribute(cap)

    def open_at(self, t):
        """The spans (start, end, name) open on the host at time ``t``."""
        k = bisect_right(self._edges, t) - 1
        return self._open[k] if k >= 0 else ()

    def _attribute(self, cap):
        calls = sorted((s, kind) for n, s, _ in cap.host_ops if (kind := _call_kind(n)))
        ops = sorted((op for op in cap.device_ops if not op[0].startswith(PREFIX)),
                     key=lambda op: op[1])
        if len(calls) != len(ops) or any(kind != _op_kind(op[0])
                                         for (_, kind), op in zip(calls, ops)):
            return None, None
        skew = min((op[1] - t for (t, _), op in zip(calls, ops)), default=0.0)
        return [(name, s, e, frozenset(n for _, _, n in self.open_at(t)))
                for (t, _), (name, s, e) in zip(calls, ops)], skew


def _segments(spans):
    """(edges, open): open[k] holds the spans open on [edges[k], edges[k + 1])."""
    edges = sorted({x for s, e, _ in spans for x in (s, e)})
    where = {x: k for k, x in enumerate(edges)}
    starts, ends = [[] for _ in edges], [[] for _ in edges]
    for sp in spans:
        starts[where[sp[0]]].append(sp)
        ends[where[sp[1]]].append(sp)
    current, out = set(), []
    for k in range(len(edges)):
        current.difference_update(ends[k])
        current.update(starts[k])
        out.append(tuple(current))
    return edges, out


def spans_of(cap):
    if cap not in _CACHE:
        _CACHE[cap] = Spans(cap)
    return _CACHE[cap]


def launched_ms(rec, inside, outside=(), skip_keys=()):
    """Device milliseconds a captured unit of the ops launched inside any
    span of ``inside`` and none of ``outside``, less the kernels whose work
    key (``benchmark.counts.kernel_key``) is in ``skip_keys``."""
    if rec.capture is None or not rec.captured:
        return None
    sp = spans_of(rec.capture)
    if sp.ops is None or not sp.names & set(inside):
        return None
    seconds = sum((e - s) * 1e-6 for name, s, e, names in sp.ops
                  if names & set(inside) and not names & set(outside)
                  and kernel_key(name) not in skip_keys)
    return 1e3 * seconds / rec.captured


def gaps(cap, skew):
    """The device's idle gaps (start, end) on the host's clock, from the
    first captured unit's start to the last op's end."""
    busy = sorted((s - skew, e - skew) for n, s, e in cap.device_ops
                  if not n.startswith(PREFIX))
    out, last = [], cap.span_us[0]
    for s, e in busy:
        if s > last:
            out.append((last, s))
        last = max(last, e)
    return out


def idle_ms(rec):
    """Device idle milliseconds a captured unit in the gaps whose middle
    falls while the host is inside a span."""
    if rec.capture is None or not rec.captured:
        return None
    sp = spans_of(rec.capture)
    if sp.ops is None or not sp.names:
        return None
    seconds = sum((e - s) * 1e-6 for s, e in gaps(rec.capture, sp.skew)
                  if sp.open_at(0.5 * (s + e)))
    return 1e3 * seconds / rec.captured
