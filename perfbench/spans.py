"""The program's spans and the device trace on one clock.

The port's recorder (``freesplat_tpu_torch/utils/profiling.py``) gives
each span its host clock (``time.perf_counter_ns``) and, on a card, the
stream's time at its ends after the recorder's origin event; a profiled
stretch (``perfbench/trace.py``) gives the device's activity on the
profiler's clock.  ``reduce`` puts both on the profiler's clock by one
anchor: a host instant taken just before the stretch's first marker
kernel is launched, right after a synchronize, against the marker's
device start (the origin event is recorded just before it, so it counts
from the same instant).  The host side is then late by the launch's
latency, a few microseconds, which the planted ``probe.sleep`` gap of
``span_stretch.py --probe`` measures.

- Busy: the union of the device's intervals in the stretch.  A span's
  busy seconds are the busy seconds inside its device interval (the
  stream's time between its events; the host interval where it has none):
  the work of the kernels it launched, since the stream runs them between
  its events.  Its own busy seconds leave out its children's.
- Idle: the stretch's holes in that union.  A span's idle seconds are the
  idle seconds inside its host interval; each hole's seconds go to the
  innermost host span open over them, or to ``(outside spans)``.

Spans nest on one thread, so a child's intervals lie inside its parent's
and "own" is the span's total less its children's.
"""
from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass

OUTSIDE = "(outside spans)"
TOP = 10


class Measure:
    """Length of the union of intervals up to any instant."""

    def __init__(self, pieces: list[tuple[float, float]]):
        self.pieces = pieces  # merged, sorted, disjoint
        self.starts = [a for a, _ in pieces]
        self.cum = [0.0]
        for a, b in pieces:
            self.cum.append(self.cum[-1] + (b - a))

    def upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        a, b = self.pieces[i - 1]
        return self.cum[i - 1] + (min(t, b) - a)

    def between(self, a: float, b: float) -> float:
        return max(0.0, self.upto(b) - self.upto(a))


def merge(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Merged [start, end) pieces of ``(start, end, ...)`` intervals,
    clipped to [lo, hi]."""
    pieces = sorted((max(iv[0], lo), min(iv[1], hi)) for iv in intervals
                    if iv[1] > lo and iv[0] < hi)
    merged: list[list[float]] = []
    for a, b in pieces:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


@dataclass
class Clock:
    """Host ns and the recorder's device offsets onto the profiler's
    clock: ``host_ns`` maps to ``at``, the origin event to ``origin``."""

    host_ns: int
    at: float
    origin: float | None = None

    def host(self, ns: int) -> float:
        return self.at + (ns - self.host_ns) * 1e-9


def paths(spans: list[dict]) -> list[str]:
    out: list[str] = []
    for s in spans:
        out.append(s["name"] if s["parent"] < 0 else out[s["parent"]] + "/" + s["name"])
    return out


def reduce(tree: dict, kernels, lo: float, hi: float, clock: Clock) -> dict:
    """``tree``: a recorder's ``flush()``; ``kernels``: ``(start, end,
    ...)`` device intervals on the profiler's clock (s); [lo, hi]: the
    stretch.  Per span: host and device intervals on the profiler's
    clock, busy and idle seconds (total and own); by path the sums; the
    idle seconds by innermost span, largest first."""
    busy = Measure(merge(kernels, lo, hi))
    spans = tree["spans"]
    names = paths(spans)

    def clip(a, b):
        return max(0.0, min(b, hi) - max(a, lo))

    rows = []
    for s in spans:
        h0, h1 = clock.host(s["t0_ns"]), clock.host(s["t1_ns"])
        if s.get("device_at") is not None and clock.origin is not None:
            d0, d1 = (clock.origin + x for x in s["device_at"])
        else:
            d0, d1 = h0, h1
        rows.append({"host": (h0, h1), "device": (d0, d1), "busy": busy.between(d0, d1),
                     "idle": clip(h0, h1) - busy.between(h0, h1)})
    own_busy = [r["busy"] for r in rows]
    own_idle = [r["idle"] for r in rows]
    for s, r in zip(spans, rows):
        if s["parent"] >= 0:
            own_busy[s["parent"]] -= r["busy"]
            own_idle[s["parent"]] -= r["idle"]
    total_busy = busy.cum[-1]
    total_idle = (hi - lo) - total_busy
    root_idle = sum(r["idle"] for s, r in zip(spans, rows) if s["parent"] < 0)
    by_path: dict[str, dict] = {}
    idle_by: dict[str, float] = {OUTSIDE: total_idle - root_idle}
    for i, (s, r) in enumerate(zip(spans, rows)):
        p = by_path.setdefault(names[i], {"count": 0, "host_s": 0.0, "busy_s": 0.0,
                                          "own_busy_s": 0.0, "idle_s": 0.0, "own_idle_s": 0.0})
        p["count"] += 1
        p["host_s"] += r["host"][1] - r["host"][0]
        p["busy_s"] += r["busy"]
        p["own_busy_s"] += own_busy[i]
        p["idle_s"] += r["idle"]
        p["own_idle_s"] += own_idle[i]
        idle_by[names[i]] = idle_by.get(names[i], 0.0) + own_idle[i]
    ranked = sorted(idle_by.items(), key=lambda kv: -kv[1])
    return {"window_s": hi - lo, "busy_s": total_busy, "idle_s": total_idle,
            "spans": rows, "paths": names, "by_path": by_path,
            "idle_by_span": [[p, s] for p, s in ranked[:TOP]]}


def _in_window(row: dict, lo: float, hi: float) -> bool:
    a, b = row["host"]
    return lo <= (a + b) / 2 <= hi


def named(tree: dict, red: dict, name: str, lo: float, hi: float) -> list[dict]:
    """Rows of the spans called ``name`` whose middle lies in the stretch."""
    return [r for s, r in zip(tree["spans"], red["spans"])
            if s["name"] == name and _in_window(r, lo, hi)]


def per_unit(tree: dict, red: dict, counter: str, root: str, lo: float, hi: float) -> list[float]:
    """Counter ``counter`` summed over each unit whose root span (``root``)
    lies in the stretch."""
    units = [s["unit"] for s, r in zip(tree["spans"], red["spans"])
             if s["name"] == root and s["parent"] < 0 and _in_window(r, lo, hi)]
    sums = {u: 0.0 for u in units}
    for c in tree["counters"]:
        if c["name"] == counter and c["unit"] in sums and c["value"] is not None:
            sums[c["unit"]] += c["value"]
    return [sums[u] for u in units]


def metrics(entry: str, tree: dict, red: dict, lo: float, hi: float) -> dict[str, float]:
    """The per-layer metrics the spans give, for the ``fit`` or the
    ``run_test`` entry (PERF.md §3 names their sources)."""
    window = hi - lo

    def busy(name):
        return sum(r["busy"] for r in named(tree, red, name, lo, hi))

    def idle(name):
        return sum(r["idle"] for r in named(tree, red, name, lo, hi))

    if entry == "fit":
        steps = named(tree, red, "step", lo, hi)
        return {
            "syncs_per_step.train": statistics.median(
                per_unit(tree, red, "host_syncs", "step", lo, hi)),
            "launch_idle_share.train": 100 * sum(
                idle(n) for n in ("step.forward", "step.backward", "step.optimizer")) / window,
            "optimizer_busy_ms.train": 1e3 * busy("step.optimizer") / len(steps),
        }
    scenes = named(tree, red, "scene", lo, hi)
    views = len(named(tree, red, "render", lo, hi))
    return {
        "syncs_per_scene.serve": statistics.median(
            per_unit(tree, red, "host_syncs", "scene", lo, hi)),
        "dumps_idle_share.serve": 100 * idle("scene.dumps") / window,
        "plane_sweep_busy_ms.serve": 1e3 * busy("encoder.cost_volume") / len(scenes),
        "binning_busy_ms_per_view.serve": 1e3 * sum(
            busy(n) for n in ("render.preprocess", "render.binning", "render.rows")) / views,
    }
