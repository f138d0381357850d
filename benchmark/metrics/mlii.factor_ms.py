"""mlii.factor_ms: the mean milliseconds a step of the port's ``Profiler``
phase "cholesky+solves" (the ML-II marginal likelihood from the Gram), over
the steps that the traced run ran under the Profiler (it waits for the
device at each phase boundary)."""

from benchmark.readers import phase_ms


def read(rec):
    return phase_ms(rec, "cholesky+solves")
