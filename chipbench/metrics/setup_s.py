"""Seconds from the process's start to the window's first request: imports,
the CUDA context, building or loading the kernels, weights, images,
planning and warm-up."""


def read(run):
    return run["setup_s"]
