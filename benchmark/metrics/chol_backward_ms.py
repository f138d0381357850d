"""chol_backward_ms.<cell>: device milliseconds a captured step of the
kernels, copies and fills launched inside the port's span
``snngp.train.backward`` and outside ``snngp.k2``: autograd's backward of
the ML-II loss without K2's, that is the Cholesky factor's, the solves' and
the log-determinant's backward (``benchmark.spans``)."""

from benchmark.spans import launched_ms


def read(rec):
    return launched_ms(rec, inside=("snngp.train.backward",), outside=("snngp.k2",))
