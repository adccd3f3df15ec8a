"""Median ms a step of PTF's forward (the encoder.ptf span), from make_train_step's timings."""
from perfbench.metrics._phase import median_ms


def read(run):
    return median_ms(run, "fit", "ptf_s")
