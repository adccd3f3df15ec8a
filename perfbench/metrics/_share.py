"""Shares read from the profiled stretch (``perfbench/trace.py``), in %."""
from perfbench.roofline.peaks import FP32_FLOPS, bound_seconds
from perfbench.trace import launches


def idle_share(run, entry):
    if run.entry != entry or run.profile is None:
        return None
    return 100.0 * run.profile["idle_share"]


def mfu(run, entry):
    """Model FLOPs of the units completed in the stretch over the stretch's
    length at the float32 peak."""
    p = run.profile
    if run.entry != entry or p is None or not run.model_flops_per_unit or not p["units"]:
        return None
    return 100.0 * run.model_flops_per_unit * p["units"] / (p["window_s"] * FP32_FLOPS)


def roofline(run, entry, kind, kernel):
    """The bound of the stretch's first unit's launches of ``kernel`` over
    their device time."""
    if run.entry != entry or run.profile is None or not run.raster or kind not in run.raster:
        return None
    work = run.raster[kind]
    times = launches(run.profile, kernel, work["launches"])
    if len(times) < work["launches"] or sum(times) <= 0:
        return None
    return 100.0 * bound_seconds(work["flops"], work["bytes"]) / sum(times)
