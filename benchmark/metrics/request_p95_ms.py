"""request_p95_ms: the 95th percentile of the client-side latency of every
request completed in the window, from handing the test points over to
holding the predictive mean and variance on the host."""

import numpy as np


def read(rec):
    if rec.kind != "requests" or not rec.units:
        return None
    return float(np.percentile([1e3 * (u["end"] - u["start"]) for u in rec.units], 95))
