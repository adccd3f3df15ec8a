"""Median ms a unit of rendering one target view, from run_test's timings."""
from perfbench.metrics._phase import median_ms


def read(run):
    return median_ms(run, "run_test", "decoder_s_per_view")
