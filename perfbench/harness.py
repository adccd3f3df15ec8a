"""The benchmark's shared machinery: finding a cell's files by name, the
record of one run, the JAX check, the metric readers and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``perfbench/configs/<config>.json``: the port's preset and overrides;
- ``perfbench/workloads/<cell>.json``: configuration, traffic, chips, why;
- ``perfbench/traffic/<mix>.json``: the mix's parameters and its entry
  (``perfbench/entries/<entry>.py``: the program call the window drives);
- ``perfbench/metrics/<metric>.py``: ``read(run) -> float | None``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Whole top-level module names that may not be loaded in a run: JAX, its
# libraries, and the JAX package that the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "freesplat_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _reports(metric: dict, cell: str, e2e_names: set[str] | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def load_cell(name: str, bench: dict | None = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell's workload, configuration and traffic files under
    ``bench_dir``, and the metrics ``bench`` (``BENCHMARK.json``) has it
    report."""
    bench = manifest() if bench is None else bench
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    config = load_json(bench_dir / "configs" / f"{workload['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{workload['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, workload, config, traffic, e2e, per_layer)


def set_environment() -> None:
    """Before torch is imported: the build and kernel caches at fixed paths
    inside the checkout, so only a cell's first run there builds (the
    port's nvcc builds already go to ``build/kernels/`` at the checkout's
    root); and one host thread for torch's and OpenMP's pools, so a run's
    host side is one thread's work and not a pool's contending for the
    machine's shared cores."""
    cache = ROOT / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


@dataclass
class Check:
    """One number compared for ``correct``: it passes while at most ``limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Run:
    """What one run of a cell measured; the metric readers read it."""

    entry: str  # the traffic's entry: "fit" (a unit is a step) or "run_test" (a scene)
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0  # completed in the window
    attempted: int = 0
    failed: int = 0
    peak_window_bytes: int = 0
    peak_process_bytes: int = 0
    checks: list[Check] = field(default_factory=list)
    notes: list[str] = field(default_factory=list)
    # --trace 1: the profiled stretch (``perfbench/trace.py``) and the
    # phase times of the stretch with ``timings=``.
    profile: dict | None = None
    timings: dict[str, list[float]] | None = None
    chunks_per_scene: int = 1
    model_flops_per_unit: float | None = None
    raster: dict | None = None  # {"fwd"|"bwd": {"flops", "bytes", "launches"}}
    marks: list[tuple[str, float]] = field(default_factory=list)  # set-up phases' ends

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.perf_counter()))

    def setup_note(self, t_start: float) -> str:
        edges = [("", t_start)] + self.marks
        return "set-up s: " + ", ".join(f"{name} {b - a:.2f}"
                                        for (_, a), (name, b) in zip(edges, edges[1:]))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def read_metric(name: str, run: Run) -> float | None:
    """``perfbench/metrics/<name>.py``'s ``read(run)``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(run)
    return None if value is None else float(value)


def entry_module(name: str):
    return importlib.import_module(f"perfbench.entries.{name}")


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` that are forbidden, compared whole
    (``freesplat_tpu_torch`` is not ``freesplat_tpu``)."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def device_info(run: Run, count: int, device="cuda") -> dict:
    import torch

    cuda = str(device).startswith("cuda")
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": count,
            "memory_peak_bytes": int(run.peak_process_bytes)}
    if run.profile is not None:
        info["busy_s"] = run.profile["busy_s"]
        info["window_s"] = run.profile["window_s"]
    return info


def checks_text(checks: list[Check]) -> dict:
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}
