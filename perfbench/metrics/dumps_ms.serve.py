"""Median ms a unit of writing a scene's PNGs, from run_test's timings."""
from perfbench.metrics._phase import median_ms


def read(run):
    return median_ms(run, "run_test", "dumps_s")
