"""idle_share.<cell>: the share of the capture's span in which no kernel,
copy or fill ran on the device."""

from benchmark.readers import idle_share


def read(rec):
    return idle_share(rec)
