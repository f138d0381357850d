"""serve.test_var_ms: device milliseconds a captured request of the ops
launched inside the port's spans ``snngp.predict.test_gram`` and
``snngp.predict.variance``: the test Gram K(xt, xt) and the variance taken
from it and the whitened cross Gram (``benchmark.spans``)."""

from benchmark.spans import launched_ms


def read(rec):
    return launched_ms(rec, inside=("snngp.predict.test_gram", "snngp.predict.variance"))
