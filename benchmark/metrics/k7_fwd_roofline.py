"""k7_fwd_roofline.<cell>: K7's forward as a share of its roofline.

The least time of its launches in the capture (``benchmark.counts``, from
the shapes) over their device time there."""

from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "k7_fwd")
