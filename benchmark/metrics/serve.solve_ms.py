"""serve.solve_ms: device milliseconds a captured request of the ops
launched inside the port's span ``snngp.predict.whiten``: the triangular
solve L^-1 K(X, xt) against the fitted factor (``benchmark.spans``)."""

from benchmark.spans import launched_ms


def read(rec):
    return launched_ms(rec, inside=("snngp.predict.whiten",))
