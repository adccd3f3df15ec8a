"""Profiling helpers and scripts of the PyTorch port, on the CPU.

``trace``/``annotate`` keep the semantics of JAX's
(``tests/test_visualization.py::test_profiling_helpers``);
``whole_scene_profile`` prints the JAX script's phase names, read from
the JAX harness's source, with non-negative seconds that sum to the
total; ``profile_stages`` and ``bench_suite`` print the JAX scripts'
metric names at tiny sizes; importing ``profile_stages`` runs nothing.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from freesplat_tpu_torch.utils.profiling import annotate, trace, trace_enabled
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


def test_trace_and_annotate(tmp_path, monkeypatch):
    with trace(str(tmp_path / "t"), enabled=False) as prof:
        pass  # disabled: nothing written
    assert prof is None and not (tmp_path / "t").exists()

    with trace(str(tmp_path / "t2")) as prof:
        with annotate("smoke"):
            float(torch.ones(4).sum())
    assert any(os.scandir(tmp_path / "t2"))
    assert "smoke" in {e.key for e in prof.key_averages()}

    monkeypatch.setenv("FREESPLAT_NO_TRACE", "1")
    assert not trace_enabled()
    with trace(str(tmp_path / "t3")) as prof:
        float(torch.ones(4).sum())
    assert prof is None and not (tmp_path / "t3").exists()


def jax_phase_names(views: int, chunk: int) -> list[str]:
    """The phases JAX's whole_scene_profile prints: the marks of the JAX
    harness's chunked encode after ``t0``, in order, a trunk mark a chunk
    named by its first view, then the tail."""
    src = (ROOT / "freesplat_tpu" / "evaluation" / "harness.py").read_text()
    names = []
    for label in re.findall(r'_mark\(f?"([^"]+)"', src):
        if label == "t0":
            continue
        if label == "B_trunk_{s}":
            names += [f"B_trunk_{s}" for s in range(0, views, chunk)]
        else:
            names.append(label)
    return names + ["tail(head->host)"]


def test_whole_scene_profile_prints_jax_phases(capsys):
    from freesplat_tpu_torch.scripts import whole_scene_profile

    reps = whole_scene_profile.main(["--views", "4", "--image-shape", "32,64", "--chunk", "2",
                                     "--reps", "2", "--depth-candidates", "8",
                                     "--device", "cpu"])
    expected = jax_phase_names(4, 2)
    assert expected == ["A_match", "A_geometry", "B_trunk_0", "B_trunk_2", "B_concat",
                        "C1_ptf", "C2_head", "tail(head->host)"]
    out = capsys.readouterr().out
    totals = [float(x) for x in re.findall(r"^\[(?:cold|warm1)\] total ([\d.]+) s$", out, re.M)]
    printed = [json.loads(x) for x in re.findall(r"^\{\n.*?^\}$", out, re.M | re.S)]
    assert len(totals) == len(printed) == len(reps) == 2
    for total, deltas, (raw_total, returned) in zip(totals, printed, reps):
        assert deltas == returned
        assert list(deltas) == expected
        assert all(v >= 0 for v in deltas.values())
        # Each value is rounded to 1 ms and the total to 10 ms.
        assert abs(sum(deltas.values()) - raw_total) <= 0.0005 * len(deltas)
        assert abs(total - raw_total) <= 0.005


def test_profile_stages_prints_jax_names(capsys):
    from freesplat_tpu_torch.scripts import profile_stages

    s = profile_stages.Shapes(h=32, w=32, depth=8, device="cpu")
    profile_stages.main(["adapter", "raster"], shapes=s)
    lines = capsys.readouterr().out.splitlines()
    names = [line.rsplit(": ", 1)[0] for line in lines]
    assert names == ["adapter fwd", "adapter fwd+bwd", "raster fwd", "raster fwd+bwd"]
    assert all(re.fullmatch(r".+: \d+\.\d\d ms", line) for line in lines)
    with pytest.raises(SystemExit):
        profile_stages.main(["cv"], shapes=s)  # JAX's default set names it; no stage has it


def test_bench_suite_raster_prints_jax_metrics(capsys):
    from freesplat_tpu_torch.scripts import bench_suite

    bench_suite.bench_raster("cpu", h=32, w=32, n=256, reps=1)
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["metric"], r["unit"]) for r in rows] == [("raster_fwd", "rays/s"),
                                                        ("raster_fwd_bwd", "rays/s")]
    assert all(r["value"] > 0 for r in rows)


def test_importing_profile_stages_runs_nothing():
    out = subprocess.run(
        [sys.executable, "-c", "import freesplat_tpu_torch.scripts.profile_stages, "
         "freesplat_tpu_torch.scripts.bench_suite, "
         "freesplat_tpu_torch.scripts.whole_scene_profile"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout == ""


def test_new_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """The eleventh slice's scripts run on the GPU unless asked for the
    CPU, and raise without one."""
    from freesplat_tpu_torch.evaluation.index_generator import (
        EvaluationIndexGenerator, EvaluationIndexGeneratorCfg,
    )
    from freesplat_tpu_torch.scripts import (
        bench_suite, compute_metrics, generalization_proof, overfit_proof, profile_stages,
        test_splatter, whole_scene_profile,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "m" / "scene" / "color").mkdir(parents=True)
    calls = [
        lambda: overfit_proof.main(["--steps", "1", "--out", str(tmp_path / "o")]),
        lambda: generalization_proof.main(["eval", "--scenes", "1", "--out", str(tmp_path)]),
        lambda: whole_scene_profile.main(["--views", "2"]),
        lambda: profile_stages.main([]),
        lambda: bench_suite.main([]),
        lambda: compute_metrics.main([f"m={tmp_path / 'm'}"]),
        lambda: EvaluationIndexGenerator(EvaluationIndexGeneratorCfg()),
        lambda: test_splatter.main(str(tmp_path / "s")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
