"""The quality-proof scripts, JAX vs the PyTorch port, on the CPU.

Both packages' ``overfit_proof`` and ``generalization_proof train`` pass
the same overrides to their ``main.main`` (recorded by a stub), with and
without a checkpoint to resume; the port's ``overfit_proof`` runs end to
end at 32x64; its ``_nearest_context_baseline`` equals JAX's on the same
3 held-out batches within 1e-4 (PSNR in dB, SSIM); and
``generalization_proof`` trains 2 steps and evaluates 2 scenes into a
``stats.json`` of JAX's structure.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
EVIDENCE = ROOT / "docs" / "evidence"
TOL = 1e-4


def recording_cli(calls: list):
    """A stand-in for ``main.main`` that records its overrides and, for a
    test run, writes the ``stats.json`` the script reads back."""
    def cli(argv, device=None):
        calls.append(list(argv))
        out = [a.split("=", 1)[1] for a in argv if a.startswith("test.output_path=")]
        if out:
            Path(out[0]).mkdir(parents=True, exist_ok=True)
            (Path(out[0]) / "stats.json").write_text(json.dumps({"summary": {"psnr": 1.0}}))
    return cli


def patch_both_mains(monkeypatch):
    import freesplat_tpu.main as jmain

    import freesplat_tpu_torch.main as tmain

    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jmain, "main", recording_cli(calls["jax"]))
    monkeypatch.setattr(tmain, "main", recording_cli(calls["port"]))
    return calls


@pytest.mark.parametrize("resume", [False, True])
def test_overfit_proof_passes_jax_overrides(tmp_path, monkeypatch, resume):
    from freesplat_tpu.scripts import overfit_proof as jproof
    from freesplat_tpu_torch.scripts import overfit_proof as tproof

    calls = patch_both_mains(monkeypatch)
    out = tmp_path / "proof"
    if resume:
        (out / "ckpt" / "step_5").mkdir(parents=True)
    argv = ["--steps", "7", "--out", str(out), "--image-shape", "32,64", "--val-every", "5"]
    jproof.main(argv)
    assert tproof.main(argv + ["--device", "cpu"]) == {"psnr": 1.0}
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == 2  # train, then test
    assert (f"checkpointing.load={out / 'ckpt'}" in calls["port"][0]) == resume


@pytest.mark.parametrize("resume", [False, True])
def test_generalization_train_passes_jax_overrides(tmp_path, monkeypatch, resume):
    from freesplat_tpu.scripts import generalization_proof as jproof
    from freesplat_tpu_torch.scripts import generalization_proof as tproof

    calls = patch_both_mains(monkeypatch)
    ckpt = tmp_path / "ckpt"
    if resume:
        (ckpt / "step_2000").mkdir(parents=True)
    argv = ["train", "--steps", "30", "--ckpt", str(ckpt), "--lr", "3e-4", "--contexts", "2"]
    jproof.main(argv)
    tproof.main(argv, device="cpu")
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == 1
    assert (f"checkpointing.load={ckpt}" in calls["port"][0]) == resume


@pytest.fixture(scope="module")
def held_out_batches():
    """The generalization proof's first 3 held-out scenes at 32x64."""
    from freesplat_tpu_torch.data.synthetic import SyntheticCfg, synthetic_batches
    from freesplat_tpu_torch.scripts.generalization_proof import EVAL_SEED

    it = synthetic_batches(SyntheticCfg(image_shape=(32, 64), num_context=3, num_target=2,
                                        seed=EVAL_SEED, vary_scene=True, renderer="tile"),
                           device="cpu")
    return [next(it) for _ in range(3)]


def test_nearest_context_baseline_matches_jax(held_out_batches):
    from freesplat_tpu.scripts.generalization_proof import (
        _nearest_context_baseline as jax_baseline,
    )
    from freesplat_tpu_torch.scripts.generalization_proof import _nearest_context_baseline

    for batch in held_out_batches:
        as_numpy = {k: {kk: np.asarray(vv) for kk, vv in batch[k].items()}
                    for k in ("context", "target")}
        ours = _nearest_context_baseline(batch)
        ref = jax_baseline(as_numpy)
        assert np.isfinite(ours).all()
        np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


def test_overfit_proof_end_to_end(tmp_path, monkeypatch):
    """The port's script through train -> checkpoint -> test at 32x64, as
    tests/test_main_cli.py::test_overfit_proof_pipeline runs JAX's."""
    from freesplat_tpu_torch.scripts.overfit_proof import main as proof

    monkeypatch.chdir(tmp_path)  # main's logger writes outputs/local/ here
    summary = proof(["--steps", "6", "--out", str(tmp_path / "proof"), "--image-shape",
                     "32,64", "--val-every", "5", "--device", "cpu"])
    stats = json.loads((tmp_path / "proof" / "test" / "stats.json").read_text())
    assert stats["summary"] == summary
    assert len(stats["per_scene"]) == 1
    assert np.isfinite(summary["psnr"])
    assert (tmp_path / "proof" / "ckpt" / "step_5").exists()
    jax_keys = json.loads((EVIDENCE / "overfit" / "stats_384x512_r3.json").read_text())[
        "summary"].keys()
    # The JAX harness has reported dropped_instances since that evidence
    # was written (freesplat_tpu/evaluation/harness.py:422).
    assert summary.keys() == set(jax_keys) | {"dropped_instances"}
    curve = [json.loads(x) for x in (tmp_path / "outputs" / "local" / "metrics.jsonl")
             .read_text().splitlines()]
    assert [r["step"] for r in curve] == [0]  # trainer.log_every=100


def test_generalization_proof_end_to_end(tmp_path, monkeypatch, held_out_batches):
    from freesplat_tpu_torch.scripts import generalization_proof as G

    monkeypatch.chdir(tmp_path)
    common = ["--image-shape", "32,64", "--ckpt", str(tmp_path / "ckpt"), "--device", "cpu"]
    G.main(["train", "--steps", "2", "--save-every", "2"] + common)
    assert (tmp_path / "ckpt" / "step_2").exists()
    report = G.main(["eval", "--scenes", "2", "--out", str(tmp_path / "eval")] + common)
    saved = json.loads((tmp_path / "eval" / "stats.json").read_text())
    assert saved == json.loads(json.dumps(report, default=float))
    jax_report = json.loads((EVIDENCE / "generalization" / "stats.json").read_text())
    assert saved.keys() == jax_report.keys()
    assert saved["protocol"] == {**jax_report["protocol"], "image_shape": [32, 64],
                                 "held_out_scenes": 2}
    for leg in ("trained", "untrained"):
        assert saved[leg].keys() == jax_report[leg].keys()
        assert all(np.isfinite(v) for v in saved[leg].values())
    nearest = [G._nearest_context_baseline(b) for b in held_out_batches[:2]]
    assert saved["nearest_context"] == {"psnr": float(np.mean([p for p, _ in nearest])),
                                        "ssim": float(np.mean([s for _, s in nearest]))}
    assert torch.get_num_threads() == 1
