"""The backward rasterizer kernel's share of its roofline, a step's 8 views (%)."""
from perfbench.metrics._share import roofline


def read(run):
    return roofline(run, "fit", "bwd", "composite_bwd")
