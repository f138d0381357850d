"""serve.points_per_s: test points served per second in the traced run,
from the end of its capture to the end of its window."""


def read(rec):
    if rec.kind != "requests" or not rec.rest_s or rec.rest_s <= 0:
        return None
    return rec.rest_points / rec.rest_s
