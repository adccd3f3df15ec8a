"""A cell added as files only: a new workload file that names an existing
mix and configuration runs, and reports its metrics, with no code edit."""
import copy
import json
import shutil
import time

from perfbench import harness
from perfbench.run import result_line, run_cell


def test_new_cell_from_files(tmp_path, small_cell):
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(harness.BENCH_DIR / sub, tmp_path / sub)
    cell = {"config": "scannet-2v", "traffic": "fit-2ctx-8tgt", "chips": 1,
            "why": "a second training cell from files only",
            "limits": {"loss_rel": 1e-2, "grad_rel": 1e-3, "change_rel": 0.1}}
    (tmp_path / "workloads" / "train-again.json").write_text(json.dumps(cell))
    bench = copy.deepcopy(harness.manifest())
    bench["workloads"].append({"name": "train-again", **{k: cell[k] for k in (
        "config", "traffic", "chips", "why")}})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "scannet2v-train" in m.get("workloads", []):
            m["workloads"].append("train-again")
    loaded = small_cell("train-again", bench=bench, bench_dir=tmp_path)
    run = run_cell(loaded, 2**31 + 9, 0.5, False, "cpu", t_start=time.perf_counter())
    line = result_line(loaded, run, False, "cpu")
    assert line["correct"] and {"setup_s", "train_step_ms"} <= set(line["metrics"])
    assert list(line)[-1] == "checks"
