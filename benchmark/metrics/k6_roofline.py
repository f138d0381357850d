"""k6_roofline.<cell>: K6 (``resnet_strided_kernel``, a WideResNet group's
leading stride-2 block) as a share of its roofline.

The least time of its launches in the capture (``benchmark.counts_resnet``,
from the shapes) over their device time there."""

from benchmark.counts_resnet import roofline


def read(rec):
    return roofline(rec, "k6")
