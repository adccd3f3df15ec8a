"""The device's idle share of the profiled evaluation stretch (%)."""
from perfbench.metrics._share import idle_share


def read(run):
    return idle_share(run, "run_test")
