"""Reductions shared by the metric readers (``metrics/<name>.py``). Each
returns None where its run has nothing to read, and the harness then leaves
the metric out of the line."""

from __future__ import annotations


def phase_ms(rec, name):
    """Mean milliseconds a step of one ``Profiler`` phase, over the steps
    the traced run ran under the Profiler."""
    if rec.kind != "steps" or not rec.phases or not rec.profiled or name not in rec.phases:
        return None
    return 1e3 * rec.phases[name] / rec.profiled


def roofline(rec, key):
    """The kernel's share of its roofline: the counted least time of its
    launches in the captured units over their device time there (%)."""
    if rec.capture is None:
        return None
    bound = sum(sum(u["work"]["launches"].get(key, ())) for u in rec.units[:rec.captured])
    seconds, count = rec.capture.kernels(key)
    if not bound or not count or seconds <= 0:
        return None
    return 100.0 * bound / seconds


def mfu(rec):
    """The captured units' counted least time over the capture's span (%)."""
    if rec.capture is None:
        return None
    least = sum(u["work"]["least_s"] for u in rec.units[:rec.captured])
    return 100.0 * least / rec.capture.window_s


def idle_share(rec):
    """The share of the capture's span in which no kernel or copy ran (%)."""
    if rec.capture is None:
        return None
    return 100.0 * (1.0 - rec.capture.busy_s / rec.capture.window_s)
