"""gram_ms.<cell>: the mean milliseconds a step of the port's ``Profiler``
phase "gram" (K1, or the three K7 blocks), over the steps that the traced
run ran under the Profiler (it waits for the device at each phase
boundary)."""

from benchmark.readers import phase_ms


def read(rec):
    return phase_ms(rec, "gram")
