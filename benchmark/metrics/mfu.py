"""mfu.<cell>: the whole step's or request's share of the chip's peak: the
least time of the captured units' counted work at the published peaks (each
operation type at its own), over the capture's span."""

from benchmark.readers import mfu


def read(rec):
    return mfu(rec)
