"""The training step's model FLOPs as a share of the float32 peak (%)."""
from perfbench.metrics._share import mfu


def read(run):
    return mfu(run, "fit")
