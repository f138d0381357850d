"""wrn.posterior_ms: the mean milliseconds a step of the port's ``Profiler``
phase "posterior" on the WideResNet Gram (the ELBO's inducing-side
inverses and eigh pseudo-inverse of the 1,000 x 1,000 K(Z, Z), and the
batch covariance), over the steps that the traced run ran under the
Profiler (it waits for the device at each phase boundary)."""

from benchmark.readers import phase_ms


def read(rec):
    return phase_ms(rec, "posterior")
