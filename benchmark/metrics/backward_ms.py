"""backward_ms.<cell>: the mean milliseconds a step of the port's
``Profiler`` phase "backward" (autograd; K2 or K7's tangent mode on the
card), over the steps that the traced run ran under the Profiler (it waits
for the device at each phase boundary)."""

from benchmark.readers import phase_ms


def read(rec):
    return phase_ms(rec, "backward")
