"""setup_s: seconds from the start of the process to the opening of the
window: imports, the CUDA context, loading (on a checkout's first run,
building) the kernels, the data, the model, the checked steps or the fit,
and the warm-up."""


def read(rec):
    return rec.setup_s
