"""The test and validation outputs, PyTorch port vs JAX package, on the CPU:
camera trajectories, PLY export, GIF writing, the trajectory videos, and
``run_test`` / ``validation_step`` with them on.

Same numpy inputs on both sides; the Gaussians of the video tests are
numpy-made and handed to both decoders, and the encoders of the harness
test share one numpy-filled flax tree (bridged).  The JAX video renders
are jitted here (its Pallas kernel in interpret mode is ~6x slower
eagerly): the same function.  Tolerances are stated beside each check.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from freesplat_tpu.config.config import load_config as jax_load_config
from freesplat_tpu.evaluation import video as jvid
from freesplat_tpu.evaluation.harness import run_test as jax_run_test
from freesplat_tpu.models import decoder as jdec
from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.models.types import Gaussians as JGaussians
from freesplat_tpu.ops import gaussians as jgauss
from freesplat_tpu.utils import camera_trajectory as jtraj
from freesplat_tpu.utils import ply_export as jply
from freesplat_tpu.utils import visualization as jvis
from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.evaluation import video as tvid
from freesplat_tpu_torch.evaluation.harness import run_test
from freesplat_tpu_torch.models import decoder as tdec
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models.types import Gaussians as TGaussians
from freesplat_tpu_torch.training.validation import validation_step
from freesplat_tpu_torch.utils import camera_trajectory as ttraj
from freesplat_tpu_torch.utils import ply_export as tply
from freesplat_tpu_torch.utils import visualization as tvis
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_encoder import fill_variables
from tests.test_torch_slice import make_scene

S = 32


def _poses(seed=0):
    """Two c2w poses a short arc apart and two intrinsics."""
    rng = np.random.default_rng(seed)
    extr = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    a = 0.3
    extr[1, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    extr[:, :3, 3] = rng.normal(size=(2, 3)) * 0.5
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (2, 1, 1))
    intr[1, 0, 0] = 1.1
    return extr, intr


def gif_frames(path):
    with Image.open(path) as im:
        return im.n_frames


# ---------------------------------------------------------------------------
# Trajectories, PLY and GIF.


def test_camera_trajectories_match_jax():
    """Within 1e-6: the same float32 formulas, and scipy's slerp on both
    sides."""
    extr, intr = _poses()
    t32 = np.linspace(0.0, 1.0, 30, dtype=np.float32)
    t64 = np.linspace(0.0, 1.0, 30)
    checks = [
        (ttraj.generate_wobble_transformation(torch.tensor([0.2, 0.4]), torch.from_numpy(t32)),
         jtraj.generate_wobble_transformation(jnp.asarray([0.2, 0.4]), jnp.asarray(t32))),
        (ttraj.generate_wobble(torch.from_numpy(extr), torch.tensor([0.1, 0.3]),
                               torch.from_numpy(t32)),
         jtraj.generate_wobble(jnp.asarray(extr), jnp.asarray([0.1, 0.3]), jnp.asarray(t32))),
        (ttraj.interpolate_intrinsics(*torch.from_numpy(intr), torch.from_numpy(t32)),
         jtraj.interpolate_intrinsics(*jnp.asarray(intr), jnp.asarray(t32))),
        (ttraj.interpolate_extrinsics(*torch.from_numpy(extr), torch.from_numpy(t64)),
         jtraj.interpolate_extrinsics(extr[0], extr[1], t64)),
        (ttraj.generate_spin(12, 20.0, 2.5), jtraj.generate_spin(12, 20.0, 2.5)),
    ]
    for i, (t, j) in enumerate(checks):
        assert tuple(t.shape) == np.asarray(j).shape, i
        assert t.dtype == torch.float32, i
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6, err_msg=str(i))
    # The interpolation starts and ends at the two poses.
    path = checks[3][0].numpy()
    np.testing.assert_allclose(path[[0, -1]], extr, atol=1e-6)


def _ply_arrays(g=50, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(g, 4)).astype(np.float32)
    return (rng.normal(size=(g, 3)).astype(np.float32),
            rng.uniform(1e-3, 0.3, (g, 3)).astype(np.float32),
            q / np.linalg.norm(q, axis=-1, keepdims=True),
            rng.normal(size=(g, 3, 4)).astype(np.float32),
            rng.uniform(0, 1, g).astype(np.float32))


def test_export_ply_equals_jax_bytes_and_round_trips(tmp_path):
    arrays = _ply_arrays()
    mask = np.random.default_rng(2).uniform(size=50) > 0.3
    for name, m in (("all", None), ("masked", mask)):
        tply.export_ply(*arrays, tmp_path / f"port_{name}.ply", mask=m)
        jply.export_ply(*arrays, tmp_path / f"jax_{name}.ply", mask=m)
        assert (tmp_path / f"port_{name}.ply").read_bytes() == (
            tmp_path / f"jax_{name}.ply").read_bytes(), name
    back = tply.load_ply(tmp_path / "port_masked.ply")
    means, scales, rot, harm, opac = (a[mask] for a in arrays)
    assert len(back["x"]) == mask.sum()
    shuffled = means @ np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32).T
    np.testing.assert_array_equal(np.stack([back[k] for k in "xyz"], -1), shuffled)
    np.testing.assert_allclose(1 / (1 + np.exp(-back["opacity"])), opac, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.exp(np.stack([back[f"scale_{i}"] for i in range(3)], -1)),
                               scales, rtol=1e-6)
    np.testing.assert_array_equal(np.stack([back[f"rot_{i}"] for i in range(4)], -1),
                                  rot[:, [3, 0, 1, 2]])
    np.testing.assert_array_equal(np.stack([back[f"f_dc_{i}"] for i in range(3)], -1),
                                  harm[:, :, 0])
    np.testing.assert_array_equal(back["nx"], 0)


def test_save_video_equals_jax_bytes(tmp_path):
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (S, S, 3), dtype=np.uint8) for _ in range(5)]
    floats = [f.astype(np.float32) / 255 for f in frames]
    for name, fs in (("u8", frames), ("f32", floats)):
        tvis.save_video(fs, tmp_path / f"port_{name}.mp4")  # .mp4 becomes .gif
        jvis.save_video(fs, tmp_path / f"jax_{name}.mp4")
        port, ref = tmp_path / f"port_{name}.gif", tmp_path / f"jax_{name}.gif"
        assert port.read_bytes() == ref.read_bytes(), name
        assert gif_frames(port) == 5
    assert not list(tmp_path.glob("*.mp4"))


def test_visualization_helpers_match_jax():
    rng = np.random.default_rng(4)
    image = rng.uniform(size=(S, S, 3)).astype(np.float32)
    pts = rng.uniform(size=(6, 2))
    ends = rng.uniform(size=(6, 2))
    for t, j in ((tvis.add_border(image, 3, 0.5), jvis.add_border(image, 3, 0.5)),
                 (tvis.draw_points(image, pts, (0, 1, 0), 2), jvis.draw_points(image, pts, (0, 1, 0), 2)),
                 (tvis.draw_lines(image, pts, ends, (1, 0, 0), 1),
                  jvis.draw_lines(image, pts, ends, (1, 0, 0), 1))):
        np.testing.assert_array_equal(t, j)
    assert [tvis.get_distinct_color(i) for i in range(8)] == [
        jvis.get_distinct_color(i) for i in range(8)]


# ---------------------------------------------------------------------------
# The videos.


def _gaussians(g=150, seed=5):
    rng = np.random.default_rng(seed)
    means = rng.uniform([-2, -2, 2.0], [2, 2, 6.0], size=(1, g, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, size=(1, g, 3)).astype(np.float32)
    quats = rng.normal(size=(1, g, 4)).astype(np.float32)
    cov = np.asarray(jgauss.build_covariance(scales, quats))
    harm = (rng.normal(size=(1, g, 3, 4)) * 0.3).astype(np.float32)
    opac = rng.uniform(0.2, 1.0, size=(1, g)).astype(np.float32)
    mask = rng.uniform(size=(1, g)) > 0.2
    return means, cov, harm, opac, mask


def _jitted_jax_render(monkeypatch):
    render = jax.jit(jdec.render_views, static_argnames=("cfg", "image_shape"))
    monkeypatch.setattr(jvid, "render_views",
                        lambda cfg, g, e, i, n, f, shape: render(cfg, g, e, i, n, f, shape))


@pytest.mark.parametrize("kind", ["wobble", "interpolation"])
def test_render_video_matches_jax(tmp_path, monkeypatch, kind):
    """30 frames at 32x32 of the same Gaussians along the same path: the
    render tests' tolerances (color 2e-5), 30 GIF frames each."""
    _jitted_jax_render(monkeypatch)
    arrays = _gaussians()
    extr, intr = _poses(6)
    cfg = dict(sh_degree=1)
    jframes = getattr(jvid, f"render_video_{kind}")(
        jdec.DecoderCfg(**cfg), JGaussians(*[jnp.asarray(a) for a in arrays]),
        jnp.asarray(extr), jnp.asarray(intr), 0.5, 15.0, (S, S), tmp_path / "jax.mp4")
    tframes = getattr(tvid, f"render_video_{kind}")(
        tdec.DecoderCfg(**cfg), TGaussians(*[torch.tensor(a) for a in arrays]),
        torch.from_numpy(extr), torch.from_numpy(intr), 0.5, 15.0, (S, S),
        tmp_path / "port.mp4")
    assert tframes.shape == np.asarray(jframes).shape == (30, S, S, 3)
    np.testing.assert_allclose(tframes, np.asarray(jframes), atol=2e-5)
    assert tframes.std() > 0.01  # the frames show the Gaussians
    assert gif_frames(tmp_path / "port.gif") == gif_frames(tmp_path / "jax.gif") == 30


# ---------------------------------------------------------------------------
# run_test and validation_step with the outputs on.


def test_run_test_writes_ply_and_videos_like_jax(tmp_path, monkeypatch):
    _jitted_jax_render(monkeypatch)
    overrides = ["dataset.image_shape=[32,32]", "encoder.num_depth_candidates=8",
                 "encoder.adapter.sh_degree=1", "decoder.sh_degree=1",
                 "test.bn_batch_stats=false", "test.save_ply=true", "test.save_video=true"]
    jcfg = jax_load_config([*overrides, f"test.output_path={tmp_path / 'jax'}"])
    tcfg = load_config([*overrides, f"test.output_path={tmp_path / 'port'}"])
    scene = make_scene(21, v_tgt=2, h=S, w=S)
    ctx = {k: jnp.asarray(a) for k, a in scene["context"].items()}
    encoder = jenc.EncoderFreeSplat(jcfg.encoder)
    var = fill_variables(jax.eval_shape(lambda c: encoder.init(jax.random.PRNGKey(0), c), ctx),
                         seed=7)
    jax_run_test(jcfg, batches=iter([scene]), state=var)
    timings = {}
    run_test(tcfg, batches=iter([scene]), state=var, device="cpu", timings=timings)
    assert len(timings["ply_s"]) == len(timings["video_s"]) == 1

    tdir, jdir = tmp_path / "port" / "scene21", tmp_path / "jax" / "scene21"
    assert {p.name for p in tdir.iterdir()} == {p.name for p in jdir.iterdir()}
    for name in ("wobble.gif", "interpolation.gif"):
        assert gif_frames(tdir / name) == gif_frames(jdir / name) == 30, name
    port, ref = tply.load_ply(tdir / "gaussians.ply"), jply.load_ply(jdir / "gaussians.ply")
    stats = json.loads((tmp_path / "port" / "stats.json").read_text())["per_scene"][0]
    assert list(port) == list(ref)
    assert len(port["x"]) == len(ref["x"]) == stats["num_gaussians"] > 0
    # The slice test's tolerances on the Gaussians (tests/test_torch_slice.py),
    # on the fields as stored: means, DC harmonics, opacity and scale
    # through their inverse maps; rotations (unit quaternions) absolute.
    sigmoid = lambda x: 1 / (1 + np.exp(-x))  # noqa: E731
    for keys, fn, rtol, atol in ((("x", "y", "z"), None, 1e-3, 1e-4),
                                 (("f_dc_0", "f_dc_1", "f_dc_2"), None, 1e-3, 1e-4),
                                 (("opacity",), sigmoid, 1e-3, 1e-4),
                                 (("scale_0", "scale_1", "scale_2"), np.exp, 1e-3, 5e-6),
                                 (("rot_0", "rot_1", "rot_2", "rot_3"), None, 0, 1e-3)):
        for k in keys:
            a, b = (port[k], ref[k]) if fn is None else (fn(port[k]), fn(ref[k]))
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)


def test_validation_step_writes_both_videos(tmp_path):
    batch = make_scene(22, v_tgt=2, h=S, w=S)
    cfg = tenc.EncoderFreeSplatCfg(num_depth_candidates=8)
    ctx = {k: jnp.asarray(a) for k, a in batch["context"].items()}
    jm = jenc.EncoderFreeSplat(jenc.EncoderFreeSplatCfg(num_depth_candidates=8))
    var = fill_variables(jax.eval_shape(lambda c: jm.init(jax.random.PRNGKey(0), c), ctx), 8)
    encoder = load_flax_variables(tenc.EncoderFreeSplat(cfg), var).train()
    out = validation_step(cfg, tdec.DecoderCfg(), encoder, batch, 5, output_dir=tmp_path,
                          save_video=True)
    assert np.isfinite(out["psnr"])
    for name in ("val_0000005_wobble.gif", "val_0000005_interpolation.gif"):
        assert gif_frames(tmp_path / name) == 30, name
    assert (tmp_path / "val_0000005.png").exists()
    with pytest.raises(NotImplementedError, match="encoder_visualizer"):
        validation_step(cfg, tdec.DecoderCfg(), encoder, batch, 5, output_dir=tmp_path,
                        save_projections=True)
