"""Median ms a scene of the encoder's trunk (backbone, cost volume, depth
network: the chunked encode's ``B_trunk_s``, summed over a scene's chunks)."""
from perfbench.metrics._phase import median_ms


def read(run):
    return median_ms(run, "run_test", "B_trunk_s", group=run.chunks_per_scene)
