"""k1_roofline.<cell>: K1 as a share of its roofline (in serving: the cross
Gram and the test Gram).

The least time of its launches in the capture (``benchmark.counts``, from
the shapes) over their device time there."""

from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "k1")
