"""k7_glue_ms.<cell>: device milliseconds a captured step of what K7's
autograd function launches besides K7's own kernels: inside the port's
spans ``snngp.k7.forward`` or ``snngp.k7.tangents``, the kernels, copies and
fills other than ``myrtle_gram_kernel`` and ``myrtle_gram_tangents_kernel``
(the per-image variance profiles, their jvp tangents, the packing, the
float64 contractions of the backward; ``benchmark.spans``)."""

from benchmark.spans import launched_ms


def read(rec):
    return launched_ms(rec, inside=("snngp.k7.forward", "snngp.k7.tangents"),
                       skip_keys=("k7_fwd", "k7_wb"))
