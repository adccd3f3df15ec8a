"""Median ms a unit of the backward (loss.backward()), from make_train_step's timings."""
from perfbench.metrics._phase import median_ms


def read(run):
    return median_ms(run, "fit", "backward_s")
