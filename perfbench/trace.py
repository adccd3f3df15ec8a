"""The profiled stretch of a traced run, reduced from ``torch.profiler``.

The profiler records the device's activity only (kernels, copies, sets),
not the host's operators: recording every operator slows the host by
about half and would read as device idle time.  Recording the device's
activity still costs the host time at each launch, so the stretch's steps
are slower than the untraced window's, and its idle share and shares of
peak include that cost (``PERF.md`` gives it for each cell).  The stretch
runs from a marker kernel launched right after the stretch's first
synchronize to one launched before its last (``torch.cuda._sleep``, a few
microseconds each); a trace without both marks is an error.  The device is
busy where any device event runs: the union of their intervals, so
overlapping streams count once.  Host spans that the profiler copies onto
the device's timeline (user annotations such as
``Optimizer.step#Adam.step``) are not device work.  Idle gaps are the
holes in that union, each labelled by the device operations on either
side of it.  Kernel times by name are summed from the device events, and
``launches`` gives the first launches of a kernel whose name contains a
given name.  Without a card (tests) it records the host's operators and
spans them all.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

MARK = "spin_kernel"  # torch.cuda._sleep's kernel
MARK_CYCLES = 1000
TOP = 10


@dataclass
class Interval:
    name: str
    start: float  # seconds on the profiler's clock
    end: float


class Stretch:
    """Start with ``begin()``, end with ``end()`` after the stretch's work
    (it synchronizes); then ``reduce()``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.host_s = 0.0

    def begin(self):
        self.prof.__enter__()
        if self.cuda:
            torch.cuda._sleep(MARK_CYCLES)
        self._t0 = time.perf_counter()

    def end(self):
        if self.cuda:
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        want = torch.autograd.DeviceType.CUDA if self.cuda else torch.autograd.DeviceType.CPU
        events = [Interval(ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
                  for ev in self.prof.events()
                  if ev.device_type == want and not getattr(ev, "is_user_annotation", False)]
        if not self.cuda:
            return summarize(events, min(iv.start for iv in events), max(iv.end for iv in events))
        marks = [iv for iv in events if MARK in iv.name]
        if len(marks) < 2:
            raise RuntimeError(f"the profiled stretch holds {len(marks)} of its 2 marker kernels")
        lo, hi = min(m.start for m in marks), max(m.end for m in marks)
        return summarize([iv for iv in events if MARK not in iv.name], lo, hi)


def union(intervals: list[Interval], lo: float, hi: float) -> list[tuple[float, float]]:
    """Merged [start, end) pieces of ``intervals`` clipped to [lo, hi]."""
    pieces = sorted((max(iv.start, lo), min(iv.end, hi)) for iv in intervals
                    if iv.end > lo and iv.start < hi)
    merged: list[list[float]] = []
    for a, b in pieces:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    for cut in ("<", "("):
        name = name.split(cut, 1)[0]
    return name.replace("void ", "").strip()[:60]


def summarize(device: list[Interval], lo: float, hi: float) -> dict:
    busy = union(device, lo, hi)
    busy_s = sum(b - a for a, b in busy)
    edges = [lo] + [x for piece in busy for x in piece] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    in_window = sorted((iv for iv in device if iv.end > lo and iv.start < hi),
                       key=lambda iv: iv.start)
    ends = sorted(in_window, key=lambda iv: iv.end)

    def around(a, b):
        prev = [iv.name for iv in ends if iv.end <= a + 1e-9]
        nxt = [iv.name for iv in in_window if iv.start >= b - 1e-9]
        return (_short(prev[-1]) if prev else "the start", _short(nxt[0]) if nxt else "the end")
    by_name: dict[str, float] = {}
    for iv in device:
        if iv.end > lo and iv.start < hi:
            by_name[iv.name] = by_name.get(iv.name, 0.0) + (iv.end - iv.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_s": hi - lo,
        "busy_s": busy_s,
        "idle_share": 1.0 - busy_s / (hi - lo),
        "device_ops": [[n[:160], s] for n, s in ops[:TOP]],
        "idle_gaps": [["host, after %s before %s" % around(a, b), g] for g, a, b in gaps[:TOP]],
        "kernels": sorted(((iv.start, iv.end, iv.name) for iv in device
                           if iv.end > lo and iv.start < hi)),
    }


def launches(profile: dict, name: str, n: int) -> list[float]:
    """Durations (s) of the first ``n`` device events whose name contains
    ``name``, in launch order."""
    found = [end - start for start, end, k in profile["kernels"] if name in k]
    return found[:n]
