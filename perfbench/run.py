"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared for
``correct`` with its limit (also the last lines on standard error).

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, without the program (``freesplat_tpu_torch``), or when JAX
or the JAX package was loaded.  See ``perfbench/README.md``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> harness.Run:
    """One run of ``cell`` on ``device`` (no look for a chip)."""
    entry = harness.entry_module(cell.traffic["entry"])
    return entry.run(cell, seed, seconds, trace, device, t_start)


def result_line(cell: harness.Cell, run: harness.Run, trace: bool, device) -> dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = harness.read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": harness.device_info(run, cell.workload["chips"], device)}
    if trace and run.profile is not None:
        line["breakdown"] = {"device_ops": run.profile["device_ops"],
                             "idle_gaps": run.profile["idle_gaps"]}
    line["checks"] = harness.checks_text(run.checks)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.set_environment()
    cell = harness.load_cell(args.workload)

    import torch

    torch.set_num_threads(1)

    need = cell.workload["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"perfbench: {args.workload} needs {need} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    try:
        import freesplat_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"perfbench: the program is missing: {exc}", file=sys.stderr)
        return 3
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    line = result_line(cell, run, bool(args.trace), "cuda")
    found = harness.forbidden_loaded()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for note in run.notes:
        print(f"perfbench: {note}", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}): {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
