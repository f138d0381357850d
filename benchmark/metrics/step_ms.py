"""step_ms.<cell>: the window over the training steps completed in it (whole
steps; the window closes on a device synchronize after the last)."""


def read(rec):
    if rec.kind != "steps" or not rec.units:
        return None
    return 1e3 * rec.window_s / len(rec.units)
