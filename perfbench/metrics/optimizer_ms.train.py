"""Median ms a unit of the clip and the Adam update, from make_train_step's timings."""
from perfbench.metrics._phase import median_ms


def read(run):
    return median_ms(run, "fit", "optimizer_s")
