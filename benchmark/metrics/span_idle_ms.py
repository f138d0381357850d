"""span_idle_ms.<cell>: device idle milliseconds a captured step or request
in the gaps whose middle falls while the host is inside one of the port's
``snngp.*`` spans, on any thread: idle that the port's own host work causes,
apart from the caller's (``benchmark.spans``)."""

from benchmark.spans import idle_ms


def read(rec):
    return idle_ms(rec)
