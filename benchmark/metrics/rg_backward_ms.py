"""rg_backward_ms.<cell>: device milliseconds a captured step of the ops
launched inside the port's span ``snngp.resnet.backward``: the WideResNet
Gram's backward, its panels' recompute through the layer tier and their
gradients (``benchmark.spans``)."""

from benchmark.spans import launched_ms


def read(rec):
    return launched_ms(rec, inside=("snngp.resnet.backward",))
