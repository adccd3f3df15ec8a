"""The evaluation slice, PyTorch port vs the JAX package, on the CPU.

SSIM, the depth metrics, the depth colormap and the ``Benchmarker`` on
numpy-seeded inputs; then ``run_test`` of both packages on the same two
32x32 scenes (D = 8, SH degree 1, BN running averages), the same encoder
weights (a flax tree filled from a seed, bridged) and the same seeded
LPIPS weights: one scene plain, one with sensor depth and an
extrapolation target (``test_fvs = 1``).  Tolerances are stated beside
each check.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesplat_tpu.config.config import load_config as jax_load_config
from freesplat_tpu.evaluation.harness import run_test as jax_run_test
from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.training import lpips as jlp
from freesplat_tpu.training import metrics as jme
from freesplat_tpu.utils import visualization as jvis
from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.evaluation.harness import run_test
from freesplat_tpu_torch.training import lpips as tlp
from freesplat_tpu_torch.training import metrics as tme
from freesplat_tpu_torch.utils import colormaps, visualization as tvis
from freesplat_tpu_torch.utils.benchmarker import Benchmarker
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_encoder import fill_variables, jax_variables
from tests.test_torch_slice import make_scene

S = 32  # run_test's image side


# ---------------------------------------------------------------------------
# Metrics.


@pytest.mark.parametrize("noise", [0.3, 1e-3])
def test_ssim_matches_jax(noise):
    """Random pairs and near-identical pairs (where ``mu_xx - mu_x**2``
    cancels): within 1e-5 of JAX's HIGHEST-precision SSIM, and <= 1 on
    both sides."""
    rng = np.random.default_rng(0)
    gt = rng.uniform(size=(3, 40, 48, 3)).astype(np.float32)
    pr = np.clip(gt + noise * rng.standard_normal(gt.shape), 0, 1).astype(np.float32)
    j = np.asarray(jax.jit(jme.compute_ssim)(jnp.asarray(gt), jnp.asarray(pr)))
    t = tme.compute_ssim(torch.from_numpy(gt), torch.from_numpy(pr)).numpy()
    assert t.shape == j.shape == (3,)
    np.testing.assert_allclose(t, j, atol=1e-5)
    assert (t <= 1.0).all() and (j <= 1.0).all()
    if noise < 0.01:
        assert (t > 0.99).all()


def test_depth_metrics_match_jax():
    """Invalid (0) sensor pixels, a zero prediction on some valid ones and
    a whole map without a valid pixel: within 1e-6 relative."""
    rng = np.random.default_rng(1)
    gt = rng.uniform(0.3, 6.0, (3, 24, 32)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.2] = 0.0
    gt[2] = 0.0
    pred = (gt * rng.uniform(0.8, 1.3, gt.shape)).astype(np.float32)
    pred[0, :4] = 0.0
    j = jme.depth_metrics(jnp.asarray(gt), jnp.asarray(pred))
    t = tme.depth_metrics(torch.from_numpy(gt), torch.from_numpy(pred))
    assert set(t) == set(j) == {"abs_diff", "abs_rel", "delta_25", "delta_10"}
    for k in j:
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-6, err_msg=k)


def test_colormap_tables_equal_matplotlib():
    """The port's copies of matplotlib's ``turbo`` and ``viridis``."""
    import matplotlib

    for name, table in colormaps.TABLES.items():
        cmap = matplotlib.colormaps[name]
        ref = cmap(np.arange(cmap.N))[:, :3]
        np.testing.assert_array_equal(np.asarray(table, np.float64), ref, err_msg=name)


def test_depth_to_color_matches_jax():
    """Equal to the JAX package's (matplotlib) colors: a depth map with
    NaN, inf, zero and negative pixels, with its own range and a
    (near, far) range that clips; and the colormap at its edges."""
    rng = np.random.default_rng(2)
    d = rng.uniform(-1.0, 20.0, (40, 50)).astype(np.float32)
    d[0, :5], d[1, :3], d[2, :3] = np.nan, np.inf, 0.0
    for args in ((d,), (d, 1.0, 5.0), (np.full((4, 4), np.nan, np.float32),)):
        np.testing.assert_array_equal(tvis.depth_to_color(*args), jvis.depth_to_color(*args))
    x = np.array([0, 1 / 256, 0.5, 255 / 256, 0.99999, 1.0, 1.5, -1.0, np.nan], np.float32)
    for cmap in ("turbo", "viridis"):
        np.testing.assert_array_equal(tvis.apply_color_map(x, cmap),
                                      jvis.apply_color_map(x, cmap))
    assert (tvis.apply_color_map(x, "turbo")[-1] == 0).all()  # NaN -> black


def test_benchmarker_tags_and_dumps(tmp_path):
    b = Benchmarker()
    with b.time("encoder"):
        pass
    with b.time("decoder", num_calls=4):
        pass
    b.store("psnr", 20)
    b.store("psnr", np.float32(22))
    assert {k: len(v) for k, v in b.execution_times.items()} == {"encoder": 1, "decoder": 4}
    assert len(set(b.execution_times["decoder"])) == 1  # equal shares of one block
    assert set(b.summarize()) == {"encoder", "decoder"}
    b.dump(tmp_path / "a" / "benchmark.json")
    b.dump_memory(tmp_path / "a" / "peak_memory.json")
    b.dump_metrics(tmp_path / "a" / "metrics.json")
    assert json.loads((tmp_path / "a" / "benchmark.json").read_text()) == {
        k: list(v) for k, v in b.execution_times.items()}
    assert json.loads((tmp_path / "a" / "metrics.json").read_text()) == {"psnr": [20.0, 22.0]}
    # No GPU here; the JAX package's CPU device gives no stats either.
    assert json.loads((tmp_path / "a" / "peak_memory.json").read_text()) == {}
    b.clear_history()
    assert not b.execution_times and not b.metrics


# ---------------------------------------------------------------------------
# run_test against the JAX harness.


def _scenes():
    """Two scenes of one shape (one JAX compile): the first with sensor
    depth (zero holes) and its last target an extrapolation view."""
    fvs, plain = make_scene(11, v_tgt=2, h=S, w=S), make_scene(12, v_tgt=2, h=S, w=S)
    rng = np.random.default_rng(13)
    depth = rng.uniform(1.0, 4.0, (1, 2, S, S)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    fvs["target"] = {**fvs["target"], "depth": depth, "test_fvs": 1}
    return [fvs, plain]


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_run_test_matches_jax(tmp_path):
    overrides = ["dataset.image_shape=[32,32]", "encoder.num_depth_candidates=8",
                 "encoder.adapter.sh_degree=1", "decoder.sh_degree=1", "test.bn_batch_stats=false"]
    jcfg = jax_load_config([*overrides, f"test.output_path={tmp_path / 'jax'}"])
    tcfg = load_config([*overrides, f"test.output_path={tmp_path / 'port'}"])
    assert tcfg.test.save_depth and tcfg.test.eval_depth  # the defaults

    ctx = {k: jnp.asarray(a) for k, a in _scenes()[0]["context"].items()}
    encoder = jenc.EncoderFreeSplat(jcfg.encoder)
    var = fill_variables(jax.eval_shape(lambda c: encoder.init(jax.random.PRNGKey(0), c), ctx),
                         seed=3)
    flat = jnp.zeros((1, S, S, 3), jnp.float32)
    lp_var = jax_variables(jlp.LPIPS(), flat, flat, seed=4)
    jsum = jax_run_test(jcfg, batches=iter(_scenes()), state=var, lpips_params=lp_var)
    tsum = run_test(tcfg, batches=iter(_scenes()), state=var,
                    lpips=tlp.make_lpips(lp_var, device="cpu"), device="cpu")

    jstats = json.loads((tmp_path / "jax" / "stats.json").read_text())
    tstats = json.loads((tmp_path / "port" / "stats.json").read_text())
    assert tstats["summary"] == tsum
    # Scene 0: interpolation_/extrapolation_ blocks and depth metrics;
    # scene 1: the plain block.
    assert {"interpolation_ssim", "extrapolation_lpips", "depth_delta_10"} <= set(
        jstats["per_scene"][0])
    assert {"psnr", "ssim", "lpips"} <= set(jstats["per_scene"][1])

    def close(k, a, b):
        # PSNR within 0.01 dB; SSIM, LPIPS and the depth metrics within
        # 1e-3 (images from Gaussians that differ by ~1e-4 relative, as in
        # tests/test_torch_slice.py; measured here: PSNR 2e-6 dB, SSIM
        # 2e-7, LPIPS 2e-8, depth metrics 1.2e-7); counts and the scene
        # key exactly.
        if isinstance(a, str) or k in ("num_views", "num_gaussians", "dropped_instances"):
            assert a == b, k
        else:
            tol = 0.01 if k.endswith("psnr") else 1e-3
            assert abs(a - b) <= tol, (k, a, b)

    for je, te in zip(jstats["per_scene"], tstats["per_scene"], strict=True):
        assert list(te) == list(je)
        for k in je:
            close(k, je[k], te[k])
    # The port's summary averages every key any scene has; JAX's takes the
    # first scene's keys only.  On those the two agree.
    extra = set(tsum) - set(jsum)
    assert extra == set(jstats["per_scene"][1]) - set(jstats["per_scene"][0])
    for k in jsum:
        close(k, jsum[k], tsum[k])

    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert "scene11/extrapolation/0001_gt.png" in _tree(tmp_path / "port")
    assert "scene12/depth_render/0001.png" in _tree(tmp_path / "port")
    for name in ("benchmark.json", "peak_memory.json"):
        j, t = (json.loads((tmp_path / p / name).read_text()) for p in ("jax", "port"))
        assert {k: len(v) for k, v in t.items()} == {k: len(v) for k, v in j.items()}, name
    # The context frames are the inputs: the same bytes.
    for p in ("scene11/context/0000.png", "scene12/context/0001.png"):
        assert (tmp_path / "port" / p).read_bytes() == (tmp_path / "jax" / p).read_bytes()
