"""The device's idle share of the profiled training stretch (%)."""
from perfbench.metrics._share import idle_share


def read(run):
    return idle_share(run, "fit")
