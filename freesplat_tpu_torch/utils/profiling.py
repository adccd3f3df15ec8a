"""Trace-level profiling helpers.

Port of ``freesplat_tpu/utils/profiling.py`` on ``torch.profiler``.
``trace(dir)`` records the host's and, when a GPU is present, the
device's activity and writes a Chrome/TensorBoard trace into ``dir``;
``annotate(name)`` is a named region in that trace.  Set
FREESPLAT_NO_TRACE=1 (or pass enabled=False) to make ``trace`` a no-op
that writes nothing.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator

import torch


def trace_enabled() -> bool:
    return os.environ.get("FREESPLAT_NO_TRACE", "0") != "1"


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool | None = None) -> Iterator[torch.profiler.profile | None]:
    """Record a trace into ``log_dir`` (``trace_<ns>.json``, Chrome trace
    format, which TensorBoard's profile plugin and Perfetto read) and
    yield the profiler, whose ``key_averages()`` tabulate the events; no
    trace and ``None`` when disabled."""
    if enabled is None:
        enabled = trace_enabled()
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up in traces (``record_function``)."""
    with torch.profiler.record_function(name):
        yield
