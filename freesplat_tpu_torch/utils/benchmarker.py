"""Timing and metric collection for the test harness.

Port of ``freesplat_tpu/utils/benchmarker.py``: a context manager per
tag, a metric store and JSON dumps.  On a CUDA device ``time`` measures
the device work queued inside the block between a pair of CUDA events,
without a synchronize: ``resolve()`` reads the pairs whose work is done
(``run_test`` calls it after a read that waited for them) and ``dump``
the rest.  Elsewhere it reads the wall clock.  ``dump_memory`` writes the port's own
format: per CUDA device, the integer entries of
``torch.cuda.memory_stats`` plus ``max_memory_allocated``; ``{}`` when no
GPU is present.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch


class Benchmarker:
    def __init__(self) -> None:
        self.execution_times: dict[str, list[float]] = defaultdict(list)
        self.metrics: dict[str, list[float]] = defaultdict(list)
        self._pending: list[tuple[str, int, torch.cuda.Event, torch.cuda.Event]] = []

    def _record(self, tag: str, num_calls: int, seconds: float) -> None:
        for _ in range(num_calls):
            self.execution_times[tag].append(seconds / num_calls)

    @contextmanager
    def time(self, tag: str, num_calls: int = 1):
        """Time the block; record ``num_calls`` equal shares of it."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._pending.append((tag, num_calls, start, end))
            return
        try:
            start = time.time()
            yield
        finally:
            self._record(tag, num_calls, time.time() - start)

    def resolve(self, wait: bool = False) -> None:
        """Record the event pairs whose work is done (all of them, after a
        synchronize, with ``wait``), in the order they were timed."""
        while self._pending:
            tag, num_calls, start, end = self._pending[0]
            if not end.query():
                if not wait:
                    return
                end.synchronize()
            self._record(tag, num_calls, start.elapsed_time(end) / 1e3)
            self._pending.pop(0)

    def store(self, tag: str, value: float) -> None:
        self.metrics[tag].append(float(value))

    @staticmethod
    def _write(path: str | Path, obj) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with path.open("w") as f:
            json.dump(obj, f)

    def dump(self, path: str | Path) -> None:
        self.resolve(wait=True)
        self._write(path, dict(self.execution_times))

    def dump_memory(self, path: str | Path) -> None:
        stats = {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                mem = {k: int(v) for k, v in torch.cuda.memory_stats(i).items()
                       if isinstance(v, (int, np.integer))}
                mem["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(i))
                stats[f"device_{i}"] = mem
        self._write(path, stats)

    def dump_metrics(self, path: str | Path) -> None:
        self._write(path, dict(self.metrics))

    def summarize(self) -> dict[str, float]:
        return {tag: float(np.mean(times)) for tag, times in self.execution_times.items()}

    def clear_history(self) -> None:
        self._pending.clear()
        self.execution_times = defaultdict(list)
        self.metrics = defaultdict(list)
