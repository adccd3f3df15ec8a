"""The forward rasterizer kernel's share of its roofline, a scene's 8 views (%)."""
from perfbench.metrics._share import roofline


def read(run):
    return roofline(run, "run_test", "fwd", "composite_fwd")
