"""Median ms a unit of the whole-scene encode, from run_test's timings."""
from perfbench.metrics._phase import median_ms


def read(run):
    return median_ms(run, "run_test", "encoder_s")
