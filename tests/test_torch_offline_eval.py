"""Offline evaluation, JAX vs the PyTorch port, on the CPU.

``run_metric_computer`` tabulates the same metrics as JAX's on the same
PNG directories (JAX's case: ``tests/test_render_extras.py::
test_metric_computer``); ``EvaluationIndexGenerator`` picks the same
entries with the same seed on the same cameras (JAX's case:
``tests/test_epipolar.py::test_index_generator_produces_valid_entries``);
``videoize_index`` and ``generate_evaluation_index.main`` on a tiny
ScanNet-layout scene write the same JSON as JAX's.
"""
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from freesplat_tpu.evaluation import index_generator as jig
from freesplat_tpu.evaluation import metric_computer as jmc
from freesplat_tpu_torch.evaluation import index_generator as tig
from freesplat_tpu_torch.evaluation import metric_computer as tmc
from tests.test_torch_data import _write_scannet_scene

# PSNR and SSIM of 8-bit frames, float32 on both sides.
TOL_PSNR, TOL_SSIM = 1e-4, 1e-5


def write_methods(root, scenes=2, frames=3):
    rng = np.random.default_rng(0)
    for method, noise in (("ours", 0.02), ("baseline", 0.2)):
        for s in range(scenes):
            scene_dir = root / method / f"scene_{s}" / "color"
            scene_dir.mkdir(parents=True)
            for i in range(frames + s):  # scenes of different lengths: weighted means
                gt = rng.uniform(size=(16, 24, 3))
                pred = np.clip(gt + rng.normal(size=gt.shape) * noise, 0, 1)
                Image.fromarray((gt * 255).astype(np.uint8)).save(scene_dir / f"{i:04}_gt.png")
                Image.fromarray((pred * 255).astype(np.uint8)).save(scene_dir / f"{i:04}.png")


def test_metric_computer_matches_jax(tmp_path, capsys):
    write_methods(tmp_path)

    def cfg(pkg, out):
        return pkg.MetricComputerCfg(
            methods=(pkg.MethodCfg("ours", "ours", str(tmp_path)),
                     pkg.MethodCfg("baseline", "baseline", str(tmp_path))),
            output_path=str(tmp_path / out))

    ref = jmc.run_metric_computer(cfg(jmc, "jax"))
    jax_table = capsys.readouterr().out
    ours = tmc.run_metric_computer(cfg(tmc, "port"), device="cpu")
    assert capsys.readouterr().out.splitlines()[0] == jax_table.splitlines()[0]
    assert ours.keys() == ref.keys() == {"ours", "baseline"}
    for method in ours:
        assert ours[method].keys() == ref[method].keys()
        assert ours[method]["num_frames"] == ref[method]["num_frames"] == 7
        assert abs(ours[method]["psnr"] - ref[method]["psnr"]) < TOL_PSNR
        assert abs(ours[method]["ssim"] - ref[method]["ssim"]) < TOL_SSIM
    assert ours["ours"]["psnr"] > ours["baseline"]["psnr"]
    saved = json.loads((tmp_path / "port" / "metrics.json").read_text())
    assert saved == ours


def test_compute_metrics_cli(tmp_path, monkeypatch):
    from freesplat_tpu_torch.scripts import compute_metrics

    write_methods(tmp_path / "runs")
    monkeypatch.chdir(tmp_path)
    table = compute_metrics.main([f"ours={tmp_path / 'runs' / 'ours'}", "--device", "cpu"])
    assert table["ours"]["num_frames"] == 7
    assert (tmp_path / "outputs" / "metrics" / "metrics.json").exists()
    with pytest.raises(SystemExit):
        compute_metrics.main(["no_path"], device="cpu")


def cam(tx=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    e = np.eye(4, dtype=np.float32)
    e[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    e[0, 3] = tx
    return e


INTR = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_generator_matches_jax(tmp_path, seed):
    """JAX's camera track (a slowly rotating camera) and generator config."""
    n = 40
    extr = np.stack([cam(yaw=0.045 * i) for i in range(n)])
    intr = np.tile(INTR, (n, 1, 1))
    gens = []
    for pkg, kw in ((jig, {}), (tig, {"device": "cpu"})):
        gen = pkg.EvaluationIndexGenerator(
            pkg.EvaluationIndexGeneratorCfg(
                min_distance=3, max_distance=30, min_overlap=0.35,
                max_overlap=0.8, num_target_views=3, subsample=4,
            ),
            seed=seed, **kw,
        )
        gen.process_scene("scene_x", extr, intr, (32, 32))
        gens.append(gen)
    ref, ours = (g.index["scene_x"] for g in gens)
    assert ours is not None
    assert (ours.context, ours.target) == (ref.context, ref.target)
    left, right = ours.context
    assert right - left >= 3 and all(left <= t <= right for t in ours.target)
    files = [g.save_index(tmp_path / name) for g, name in zip(gens, ("jax", "port"))]
    assert files[0].read_text() == files[1].read_text()


def test_view_overlap_matches_jax():
    import torch

    for yaw in (0.0, 0.2, 0.5, 1.2):
        ref = jig.view_overlap(cam(), INTR, cam(tx=0.1, yaw=yaw), INTR, (32, 32), stride=4)
        ours = tig.view_overlap(*(torch.from_numpy(x) for x in (cam(), INTR,
                                                                 cam(tx=0.1, yaw=yaw), INTR)),
                                (32, 32), stride=4)
        np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_videoize_index_matches_jax(tmp_path):
    from freesplat_tpu.scripts import generate_video_evaluation_index as jv
    from freesplat_tpu_torch.scripts import generate_video_evaluation_index as tv

    assets = Path(__file__).resolve().parents[1] / "assets"
    index = json.loads((assets / "evaluation_index_scannet_2views.json").read_text())
    index["missing"] = None
    assert tv.videoize_index(index) == jv.videoize_index(index)
    src = tmp_path / "in.json"
    src.write_text(json.dumps(index))
    jv.main([str(src), str(tmp_path / "jax.json")])
    tv.main([str(src), str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    with pytest.raises(SystemExit):
        tv.main([str(src)])


def test_generate_evaluation_index_matches_jax(tmp_path):
    from freesplat_tpu.scripts import generate_evaluation_index as jgen
    from freesplat_tpu_torch.scripts import generate_evaluation_index as tgen

    _write_scannet_scene(tmp_path / "data", n=30)
    (tmp_path / "data" / "train").rename(tmp_path / "data" / "test")
    (tmp_path / "data" / "train_idx.txt").rename(tmp_path / "data" / "test_idx.txt")
    # A track that turns as it moves, so that some pair's overlap falls
    # within the generator's [0.4, 0.8].
    scene = tmp_path / "data" / "test" / "scene0000_00"
    np.save(scene / "extrinsics.npy", np.stack([cam(tx=0.05 * i, yaw=0.02 * i)
                                                for i in range(30)]))
    outs = []
    for pkg, name, kw in ((jgen, "jax", {}), (tgen, "port", {"device": "cpu"})):
        argv = [f"dataset.roots=[{tmp_path / 'data'}]", "dataset.image_shape=[48,64]",
                f"test.output_path={tmp_path / name}"]
        pkg.main(argv, **kw)
        outs.append(json.loads((tmp_path / name / "evaluation_index.json").read_text()))
    assert outs[1] == outs[0]
    assert outs[1]["scene0000_00"] is not None
