"""k5_roofline.<cell>: K5 (``resnet_tail_kernel``, the WideResNet's
stride-1 residual blocks) as a share of its roofline.

The least time of its launches in the capture (``benchmark.counts_resnet``,
from the shapes) over their device time there."""

from benchmark.counts_resnet import roofline


def read(rec):
    return roofline(rec, "k5")
