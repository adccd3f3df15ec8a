"""Set-up: process start to the window's start (weights, scenes, the
program's state, kernels built or loaded, warm-up units)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
