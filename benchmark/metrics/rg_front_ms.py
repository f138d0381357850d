"""rg_front_ms.<cell>: device milliseconds a captured step of the ops
launched inside the port's span ``snngp.resnet.front``: the WideResNet
Gram's input moment, initial conv and variance maps, before K5 and K6
(``benchmark.spans``)."""

from benchmark.spans import launched_ms


def read(rec):
    return launched_ms(rec, inside=("snngp.resnet.front",))
