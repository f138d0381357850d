"""elbo.posterior_ms: the mean milliseconds a step of the port's
``Profiler`` phase "posterior" (the ELBO's inducing-side inverses, eigh
pseudo-inverse and batch covariance), over the steps that the traced run
ran under the Profiler (it waits for the device at each phase boundary)."""

from benchmark.readers import phase_ms


def read(rec):
    return phase_ms(rec, "posterior")
