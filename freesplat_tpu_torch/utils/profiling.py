"""Trace-level profiling: the port's span-and-counter recorder.

Port of ``freesplat_tpu/utils/profiling.py`` on ``torch.profiler``, and
the one recorder the port's layers report to.

``trace(dir)`` records the host's and, when a GPU is present, the
device's activity and writes a Chrome/TensorBoard trace into ``dir``.
Set FREESPLAT_NO_TRACE=1 (or pass enabled=False) to make ``trace`` a
no-op that writes nothing.

``span(name, **attrs)`` marks a stretch of the program and
``count(name, value, **attrs)`` records a counter.  Both go to the
recorder made active by ``with recording(rec):`` (a context variable, so
no layer takes a parameter for it); with none active they record nothing
and allocate nothing: a span site costs one context-variable lookup.  A
span records its name, its parent, its unit (the ``unit=`` attribute of
the span or of its nearest ancestor: a step in ``fit``, a scene in
``run_test``), the host clock at its ends (``time.perf_counter_ns``) and,
on CUDA, a pair of timing events recorded on the current stream.  The
recorder never synchronizes: the events and the counters whose value is
a device tensor stay unresolved until ``flush()``, which the caller calls
after its stretch or where it blocks anyway.  While ``torch.profiler``
records, each span is also a ``record_function`` range, and ``annotate``
is ``span`` (a ``record_function`` range alone while no recorder is
active).

``timed(timings, keys)`` is ``timings=``'s view of the spans: inside it
the spans the keys name synchronize the device at both ends, and on exit
each key gets the host seconds of its spans, as the phase timers did.

``host_value``, ``host_array`` and ``upload`` are the reads and copies
that wait for the device, and ``synced_inside`` counts the reads a torch
op makes inside: each is one ``host_syncs`` at its site.  Sites count
where the data would make them wait on a GPU, so a CPU run counts what
a card's run does.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import time
from pathlib import Path
from typing import Any, Iterator, Mapping

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_ACTIVE: contextvars.ContextVar["Recorder | None"] = contextvars.ContextVar(
    "freesplat_recorder", default=None)


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


class SpanRecord:
    """One span: host clock at its ends in ns, and on CUDA its events;
    ``flush()`` sets ``device_s`` (the stream's time from start to end)
    and ``device_at`` (the stream's time of its start and end after the
    recorder's origin event, when it has one)."""

    __slots__ = ("name", "parent", "unit", "attrs", "t0", "t1", "ev0", "ev1", "device_s",
                 "device_at")

    def __init__(self, name: str, parent: int, unit: Any, attrs: dict):
        self.name, self.parent, self.unit, self.attrs = name, parent, unit, attrs
        self.t0 = self.t1 = 0
        self.ev0 = self.ev1 = None
        self.device_s: float | None = None
        self.device_at: tuple[float, float] | None = None


class CounterRecord:
    __slots__ = ("name", "value", "unit", "span", "attrs")

    def __init__(self, name: str, value, unit: Any, span: int, attrs: dict):
        self.name, self.value, self.unit, self.span, self.attrs = name, value, unit, span, attrs


class Recorder:
    """Spans and counters in memory, in the order they began.

    ``events``: record a CUDA event pair a span (default: when CUDA is
    available).  ``sync`` holds the span names that synchronize the
    device at both ends (``timed`` fills it; empty, nothing synchronizes).
    One thread records into a recorder."""

    def __init__(self, events: bool | None = None):
        self.spans: list[SpanRecord] = []
        self.counters: list[CounterRecord] = []
        self.sync: set[str] = set()
        self.events = torch.cuda.is_available() if events is None else events
        self.origin_event: torch.cuda.Event | None = None
        self._stack: list[int] = []
        self._pool: list[torch.cuda.Event] = []
        self._unresolved: list[SpanRecord] = []

    def _event(self) -> torch.cuda.Event:
        ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def origin(self) -> None:
        """Record the event that ``device_at`` counts from (on CUDA; the
        caller launches its anchor right after it)."""
        if self.events:
            self.origin_event = torch.cuda.Event(enable_timing=True)
            self.origin_event.record()

    def _unit(self) -> Any:
        return self.spans[self._stack[-1]].unit if self._stack else None

    def enter(self, name: str, attrs: dict) -> int:
        parent = self._stack[-1] if self._stack else -1
        unit = attrs.pop("unit") if "unit" in attrs else self._unit()
        rec = SpanRecord(name, parent, unit, attrs)
        if name in self.sync:
            _synchronize()
        rec.t0 = time.perf_counter_ns()
        if self.events:
            rec.ev0 = self._event()
        self.spans.append(rec)
        self._stack.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def exit(self, index: int) -> None:
        rec = self.spans[index]
        if self.events:
            rec.ev1 = self._event()
            self._unresolved.append(rec)
        if rec.name in self.sync:
            _synchronize()
        rec.t1 = time.perf_counter_ns()
        self._stack.pop()

    def count(self, name: str, value, attrs: dict) -> None:
        span = self._stack[-1] if self._stack else -1
        unit = attrs.pop("unit") if "unit" in attrs else self._unit()
        self.counters.append(CounterRecord(name, value, unit, span, attrs))

    def flush(self) -> dict:
        """Resolve the events and the device-tensor counters (one
        synchronize, when any is pending) and return ``to_dict()``."""
        tensors = [c for c in self.counters if isinstance(c.value, torch.Tensor)]
        if self._unresolved:
            _synchronize()
        for c in tensors:
            c.value = c.value.item()
        for rec in self._unresolved:
            rec.device_s = rec.ev0.elapsed_time(rec.ev1) / 1e3
            if self.origin_event is not None:
                rec.device_at = (self.origin_event.elapsed_time(rec.ev0) / 1e3,
                                 self.origin_event.elapsed_time(rec.ev1) / 1e3)
            self._pool += [rec.ev0, rec.ev1]
            rec.ev0 = rec.ev1 = None
        self._unresolved.clear()
        return self.to_dict()

    def to_dict(self) -> dict:
        """Plain data: each span's name, parent index, unit, attributes,
        host start and end (ns), host self time (its length less its
        children's) and device times; each counter's name, value, unit,
        innermost open span and attributes.  Unflushed device values are
        ``None``."""
        child_ns = [0] * len(self.spans)
        for rec in self.spans:
            if rec.parent >= 0:
                child_ns[rec.parent] += rec.t1 - rec.t0
        spans = [{"name": r.name, "parent": r.parent, "unit": r.unit, "attrs": r.attrs,
                  "t0_ns": r.t0, "t1_ns": r.t1, "self_ns": r.t1 - r.t0 - child_ns[i],
                  "device_s": r.device_s,
                  "device_at": None if r.device_at is None else list(r.device_at)}
                 for i, r in enumerate(self.spans)]
        counters = [{"name": c.name, "unit": c.unit, "span": c.span, "attrs": c.attrs,
                     "value": None if isinstance(c.value, torch.Tensor) else c.value}
                    for c in self.counters]
        return {"spans": spans, "counters": counters}

    def to_json(self) -> str:
        return json.dumps(self.flush(), default=str)

    def totals(self, name: str) -> dict:
        """Counter ``name`` summed by unit (resolved values only)."""
        out: dict = {}
        for c in self.counters:
            if c.name == name and not isinstance(c.value, torch.Tensor):
                out[c.unit] = out.get(c.unit, 0) + c.value
        return out


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Span:
    __slots__ = ("rec", "name", "attrs", "index", "range")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.index = self.rec.enter(self.name, self.attrs)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec.exit(self.index)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def active() -> Recorder | None:
    """The active recorder, or None."""
    return _ACTIVE.get()


def span(name: str, **attrs):
    """A context manager marking a span of the active recorder (nothing
    without one).  ``unit=`` makes the span a unit's root."""
    rec = _ACTIVE.get()
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, attrs)


def count(name: str, value, **attrs) -> None:
    """Record counter ``name`` (a number, or a device tensor resolved at
    ``flush()``) under the innermost open span."""
    rec = _ACTIVE.get()
    if rec is not None:
        rec.count(name, value, attrs)


@contextlib.contextmanager
def recording(rec: Recorder | None) -> Iterator[Recorder | None]:
    """Make ``rec`` the active recorder inside (None: no recorder)."""
    token = _ACTIVE.set(rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)


def annotate(name: str):
    """Named region in traces: a span while a recorder is active, else a
    ``record_function`` range."""
    if _ACTIVE.get() is not None:
        return span(name)
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(timings: dict[str, list[float]] | None,
          keys: Mapping[str, tuple[str, ...]]) -> Iterator[None]:
    """``timings=``'s view of the spans recorded inside.  ``keys`` maps
    each key to (first span, last span[, attribute]): the key gets, for
    each pair of those spans in order, the host seconds from the first's
    start to the last's end (divided by the first's attribute when
    named).  Those spans synchronize the device at both ends, so each
    time covers the device work queued inside it.  Nothing without
    ``timings``.  The spans go to the active recorder, or to one of this
    block's own."""
    if timings is None:
        yield
        return
    rec = _ACTIVE.get()
    if rec is None:
        rec = Recorder(events=False)
    names = {n for spec in keys.values() for n in spec[:2]}
    added = names - rec.sync
    rec.sync |= added
    first = len(rec.spans)
    try:
        with recording(rec):
            yield
    finally:
        rec.sync -= added
    spans = rec.spans[first:]
    for key, spec in keys.items():
        starts = [r for r in spans if r.name == spec[0]]
        ends = [r for r in spans if r.name == spec[1]]
        for a, b in zip(starts, ends):
            seconds = (b.t1 - a.t0) / 1e9
            if len(spec) > 2:
                seconds /= a.attrs[spec[2]]
            timings.setdefault(key, []).append(seconds)


def host_value(x: torch.Tensor, site: str):
    """``x.item()``: a read that waits for the device, counted."""
    count("host_syncs", 1, site=site)
    return x.item()


def host_array(x: torch.Tensor, site: str) -> np.ndarray:
    """``x`` copied to the host as a numpy array (waits for the device),
    counted."""
    count("host_syncs", 1, site=site)
    return x.cpu().numpy()


def upload(x, device: torch.device, site: str, dtype=torch.float32) -> torch.Tensor:
    """``x`` (an array, a list, a number or a tensor) on ``device`` as
    ``dtype``.  From host memory it is counted: to a GPU that is a
    blocking copy from pageable memory."""
    t = torch.as_tensor(x, dtype=dtype)
    if t.device.type == "cpu":
        count("host_syncs", 1, site=site)
    return t.to(device)


def synced_inside(site: str, n: int = 1) -> None:
    """Count ``n`` reads that a torch op makes of the device before it
    returns: ``linalg.inv``'s error check, the size of a boolean mask's
    selection (``nonzero``), ``bincount``'s range."""
    count("host_syncs", n, site=site)
