"""The RealEstate10K path, PyTorch port vs JAX package, on the CPU.

Chunks are written with ``torch.save`` as ``tests/test_re10k.py::
make_chunk`` writes them.  Held against JAX: ``convert_poses``; the
chunk dataset (every array equal, the wide-FoV and wrong-shape skips,
and a scene whose evaluation-index entry is null, which the port skips
and JAX stops on); the streamed data module (batch order, two ranks, the
curriculum step, the iterable validation wrapper); the samplers and
shims the port gained; the RE10K encoder (depth planes linear in inverse
depth, near 1, far 100) in both BN regimes; one train step with the
preset's clip of 0.05; ``run_test`` on a chunk through both CLIs' data
routing.  Tolerances are stated beside each check.
"""
import dataclasses
import functools
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from freesplat_tpu.config.config import load_config as jax_load_config
from freesplat_tpu.data import data_module as jdm
from freesplat_tpu.data import re10k as jre
from freesplat_tpu.data import shims as jsh
from freesplat_tpu.data import view_samplers as jvs
from freesplat_tpu.evaluation.harness import run_test as jax_run_test
from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.training import trainer as jtr
from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.data import data_module as tdm
from freesplat_tpu_torch.data import re10k as tre
from freesplat_tpu_torch.data import shims as tsh
from freesplat_tpu_torch.data import view_samplers as tvs
from freesplat_tpu_torch.evaluation.harness import run_test
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.training import trainer as ttr
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables, torch_to_jax_variables
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_encoder import _n, _t, fill_variables

S = 32  # image side of the model tests
INDEX = str(Path(__file__).resolve().parents[1] / "assets" / "evaluation_index_re10k_2views.json")


def pack_pose(fx, fy, cx, cy, w2c):
    return np.concatenate(
        [[fx, fy, cx, cy, 0.0, 0.0], np.asarray(w2c[:3]).reshape(-1)]).astype(np.float32)


def make_scene_dict(key, n_frames=30, fx=0.9, shape=(36, 64), seed=1, smooth=False):
    """One chunk entry: cameras stepping along x (as tests/test_re10k.py's
    fixture), JPEG frames of ``shape``: random pixels, or with ``smooth``
    16-pixel patches plus noise (frames a model can be scored on)."""
    rng = np.random.default_rng(seed)
    cameras = []
    for i in range(n_frames):
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = -0.1 * i
        w2c[2, 3] = 0.02 * i
        cameras.append(pack_pose(fx, fx * shape[1] / shape[0], 0.5, 0.5, w2c))
    images = []
    for _ in range(n_frames):
        if smooth:
            coarse = rng.uniform(0.1, 0.9, size=(-(-shape[0] // 16), -(-shape[1] // 16), 3))
            a = np.repeat(np.repeat(coarse, 16, axis=0), 16, axis=1)[:shape[0], :shape[1]]
            a = (255 * np.clip(a + 0.03 * rng.standard_normal(a.shape), 0, 1)).astype(np.uint8)
        else:
            a = rng.integers(0, 255, (*shape, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG")
        images.append(torch.frombuffer(bytearray(buf.getvalue()), dtype=torch.uint8))
    return {"key": key, "cameras": torch.tensor(np.stack(cameras)), "images": images}


def write_chunk(root, stage, name, scenes):
    out = root / stage
    out.mkdir(parents=True, exist_ok=True)
    torch.save(scenes, out / f"{name}.torch")


def write_index_scene_chunk(root, stage="test", seed=5):
    """The first scene of the RE10K 2-view evaluation index with real
    360x640 frames (134 of them: the index's last frame is 133), in a
    chunk; returns its key."""
    key, entry = next((k, v) for k, v in json.loads(open(INDEX).read()).items() if v)
    n = max(entry["context"] + entry["target"]) + 1
    write_chunk(root, stage, "000000",
                [make_scene_dict(key, n_frames=n, shape=(360, 640), seed=seed, smooth=True)])
    return key


def _cfg(m, stage_root, size=S):
    return m.DatasetRE10kCfg(roots=(str(stage_root),), image_shape=(size, size),
                             expected_shape=(36, 64))


def _bounded(vs, seed=0):
    return vs.ViewSamplerBounded(
        vs.ViewSamplerBoundedCfg(
            num_context_views=2, min_distance_between_context_views=6,
            max_distance_between_context_views=10, min_distance_to_context_views=2,
            warm_up_steps=0),
        seed=seed)


def _assert_examples_equal(te, je):
    assert te["scene"] == je["scene"]
    assert te["target"]["test_fvs"] == je["target"]["test_fvs"]
    for part in ("context", "target"):
        assert set(te[part]) == set(je[part])
        for k in je[part]:  # numpy and PIL on both sides: equal arrays
            np.testing.assert_array_equal(np.asarray(te[part][k]), np.asarray(je[part][k]),
                                          err_msg=f"{part} {k}")


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """Train chunks: two usable scenes, a wide-FoV one (fov_x 118 degrees)
    and one with 40x40 frames, then a second chunk with one more scene;
    a test chunk whose middle scene has a null index entry."""
    root = tmp_path_factory.mktemp("re10k")
    scene = functools.partial(make_scene_dict, smooth=True)  # frames as the slice test's
    write_chunk(root, "train", "000000", [
        scene("ok_a", seed=1), scene("wide", fx=0.3, seed=2),
        scene("wrong", shape=(40, 40), seed=3), scene("ok_b", seed=4)])
    write_chunk(root, "train", "000001", [scene("ok_c", n_frames=24, seed=6)])
    write_chunk(root, "test", "000000", [
        scene("ok_a", seed=1), scene("e74ceac9043aa1b8", seed=7), scene("ok_b", seed=4)])
    index = root / "index.json"
    index.write_text(json.dumps({
        "ok_a": {"context": [2, 12], "target": [5, 9]},
        "e74ceac9043aa1b8": None,
        "ok_b": {"context": [0, 20], "target": [3, 10, 17]},
    }))
    return root, index


# ---------------------------------------------------------------------------
# Data.


def test_convert_poses_matches_jax():
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(0)
    rows = []
    for _ in range(5):
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = Rotation.random(random_state=rng).as_matrix()
        w2c[:3, 3] = rng.normal(size=3)
        rows.append(pack_pose(*rng.uniform(0.5, 1.5, 4), w2c))
    rows = np.stack(rows)
    for got, want in zip(tre.convert_poses(rows), jre.convert_poses(rows)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_dataset_matches_jax_and_skips(chunks):
    root, index = chunks
    tds = tre.DatasetRE10k(_cfg(tre, root), "train", _bounded(tvs), seed=3)
    jds = jre.DatasetRE10k(_cfg(jre, root), "train", _bounded(jvs), seed=3)
    assert tds.chunk_paths == jds.chunk_paths
    for _ in range(2):  # two passes: the chunk order is drawn anew each time
        got, want = list(tds.examples()), list(jds.examples())
        assert sorted(e["scene"] for e in got) == ["ok_a", "ok_b", "ok_c"]  # wide, wrong skipped
        for te, je in zip(got, want, strict=True):
            _assert_examples_equal(te, je)
    assert got[0]["context"]["image"].shape == (2, 32, 32, 3)

    def evaluation(m, vs):
        sampler = vs.ViewSamplerEvaluation(vs.ViewSamplerEvaluationCfg(index_path=str(index)))
        return m.DatasetRE10k(_cfg(m, root), "test", sampler, seed=3)

    got = list(evaluation(tre, tvs).examples())
    assert [e["scene"] for e in got] == ["ok_a", "ok_b"]  # the null entry is skipped
    jit = evaluation(jre, jvs).examples()
    _assert_examples_equal(got[0], next(jit))
    with pytest.raises(KeyError, match="e74ceac9043aa1b8"):  # JAX stops on it
        next(jit)
    np.testing.assert_array_equal(got[1]["target"]["index"], [3, 10, 17])


def _modules(root, index=None, step_fn=None, record=None, size=S):
    """The data modules of both packages over the same chunks (no
    prefetch thread); ``record`` collects each package's set_step calls."""
    out = []
    for name, dm, m, vs in (("port", tdm, tre, tvs), ("jax", jdm, jre, jvs)):
        def factory(stage, m=m, vs=vs, name=name):
            if stage != "test":  # as main.make_view_sampler: val is bounded too
                sampler = _bounded(vs)
                if record is not None:
                    own = sampler.set_step
                    sampler.set_step = lambda s, own=own, n=name: (record[n].append(s), own(s))
            else:
                sampler = vs.ViewSamplerEvaluation(
                    vs.ViewSamplerEvaluationCfg(index_path=str(index)))
            return m.DatasetRE10k(_cfg(m, root, size), stage, sampler, seed=7)

        out.append(dm.DataModule(factory, dm.DataLoaderStageCfg(batch_size=1, seed=9),
                                 step_fn=step_fn, prefetch=0))
    return out


def _batches_equal(tb, jb):
    assert tb["scene"] == jb["scene"]
    for part in ("context", "target"):
        for k in jb[part]:
            np.testing.assert_array_equal(np.asarray(tb[part][k]), np.asarray(jb[part][k]),
                                          err_msg=f"{part} {k}")


def test_streamed_data_module_matches_jax(chunks, monkeypatch):
    root, index = chunks
    step = {"value": 0}
    record = {"port": [], "jax": []}
    tmod, jmod = _modules(root, index, step_fn=lambda: step["value"], record=record)
    tit, jit = tmod.train_batches(), jmod.train_batches()
    order = []
    for i in range(7):  # past the end of a pass: the stream loops
        step["value"] = 10 * i
        tb, jb = next(tit), next(jit)
        _batches_equal(tb, jb)
        order.append(tb["scene"][0])
        assert tb["context"]["image"].shape == (1, 2, 32, 32, 3)
    assert sorted(order[:3]) == ["ok_a", "ok_b", "ok_c"]
    # The step reaches the sampler before each next(): the same calls.
    assert record["port"] == record["jax"] and record["port"][-1] == 60

    # Two processes, one pass (loop=False): examples dealt round-robin,
    # the same share in both packages.
    shares = []
    for rank in (0, 1):
        monkeypatch.setattr(tdm, "process_rank", lambda r=rank: (r, 2))
        monkeypatch.setattr(jdm.DataModule, "_process_rank", staticmethod(lambda r=rank: (r, 2)))
        tmod, jmod = _modules(root, index)
        tbs, jbs = (list(m._stream(m.dataset_factory("train"), shuffle=True, loop=False))
                    for m in (tmod, jmod))
        for tb, jb in zip(tbs, jbs, strict=True):
            _batches_equal(tb, jb)
        shares.append([b["scene"][0] for b in tbs])
    assert sorted(shares[0] + shares[1]) == ["ok_a", "ok_b", "ok_c"]
    assert len(shares[0]) == 2 and len(shares[1]) == 1


def test_iterable_validation_wrapper_cycles(chunks, tmp_path):
    root, index = chunks
    tmod, jmod = _modules(root, index)
    tit, jit = tmod.val_batches(), jmod.val_batches()
    scenes = []
    for _ in range(5):  # the val stage reads test/'s chunk, then again
        tb, jb = next(tit), next(jit)
        _batches_equal(tb, jb)
        scenes.append(tb["scene"][0])
    assert scenes == ["ok_a", "e74ceac9043aa1b8", "ok_b", "ok_a", "e74ceac9043aa1b8"]
    (tmp_path / "test").mkdir()
    for wrapper in (tdm.ValidationWrapper, jdm.ValidationWrapper):
        empty = tre.DatasetRE10k(_cfg(tre, tmp_path), "val", _bounded(tvs))
        with pytest.raises(RuntimeError, match="no examples"):
            next(iter(wrapper(empty)))


def test_new_samplers_and_shims_match_jax(chunks):
    root, _ = chunks
    extr, intr = tre.convert_poses(np.stack(
        [pack_pose(0.9, 1.6, 0.5, 0.5, np.eye(4)) for _ in range(6)]))
    extr[:, 0, 3] = np.linspace(0, 0.5, 6)
    for t, j in ((tvs.ViewSamplerArbitrary(tvs.ViewSamplerArbitraryCfg((1, 4), (2, 3))),
                  jvs.ViewSamplerArbitrary(jvs.ViewSamplerArbitraryCfg((1, 4), (2, 3)))),
                 (tvs.ViewSamplerAll(), jvs.ViewSamplerAll())):
        for a, b in zip(t.sample("s", extr, intr), j.sample("s", extr, intr), strict=True):
            np.testing.assert_array_equal(a, b)
    assert set(tvs.SAMPLERS) == set(jvs.SAMPLERS)

    ds = tre.DatasetRE10k(_cfg(tre, root), "train", _bounded(tvs), seed=3)
    example = next(ds.examples())
    example["context"]["depth"] = np.linspace(1, 2, 2 * 32 * 32, dtype=np.float32).reshape(
        2, 32, 32)
    flipped = 0
    for seed in range(4):  # both branches of the coin
        t = tsh.apply_augmentation_shim(example, np.random.default_rng(seed))
        j = jsh.apply_augmentation_shim(example, np.random.default_rng(seed))
        _assert_examples_equal(t, j)
        flipped += t is not example
    assert 0 < flipped < 4
    _assert_examples_equal(tsh.apply_patch_shim(example, 14), jsh.apply_patch_shim(example, 14))
    ctx = example["context"]
    args = (ctx["extrinsics"], ctx["intrinsics"], (32, 32), 2.0)
    assert tsh.compute_depth_for_disparity(*args) == jsh.compute_depth_for_disparity(*args)
    _assert_examples_equal(tsh.apply_bounds_shim(example, 8.0, 0.5),
                           jsh.apply_bounds_shim(example, 8.0, 0.5))


# ---------------------------------------------------------------------------
# The model at RE10K's settings.


def _re10k_configs(*extra, size=S):
    args = ["+experiment=re10k/2views", f"dataset.image_shape=[{size},{size}]",
            "encoder.num_depth_candidates=8", *extra]
    return jax_load_config(args), load_config(args)


def _batch(root, size=S):
    """The first train batch of the RE10K data module: 2 context and 4
    target views (the bounded sampler's per-gap targets)."""
    (tmod, _) = _modules(root, size=size)
    return next(tmod.train_batches())


@pytest.mark.parametrize("train_bn,size", [(True, 64), (False, S)],
                         ids=["batch_stats", "running_average"])
def test_re10k_encoder_matches_jax(chunks, train_bn, size):
    """Batch-statistics BN runs at 64x64: at 32x32 its stride-32 stage
    normalizes each channel over 2 values, and float32 rounding moves
    ``depth_s-1`` by up to 4.2e-2 relative in this preset and 6.8e-2 in
    ``scannet/2views`` alike (1.2e-2 and 2.3e-2 relative L2); at 64x64
    both read 1e-5 (ROADMAP section 3, batch-statistics BN)."""
    jcfg, tcfg = _re10k_configs(f"encoder.train_bn={str(train_bn).lower()}", size=size)
    assert not tcfg.encoder.log_planes and (tcfg.encoder.near, tcfg.encoder.far) == (1.0, 100.0)
    assert dataclasses.asdict(tcfg.encoder) == dataclasses.asdict(jcfg.encoder)
    ctx = {k: v for k, v in _batch(chunks[0], size)["context"].items() if k != "index"}
    jm = jenc.EncoderFreeSplat(jcfg.encoder)
    jctx = {k: jnp.asarray(a) for k, a in ctx.items()}
    var = fill_variables(jax.eval_shape(lambda c: jm.init(jax.random.PRNGKey(0), c), jctx), 2)
    apply = jax.jit(lambda v, c: jm.apply(v, c, mutable=["batch_stats"])[0])
    jout = apply(var, jctx)
    tm = load_flax_variables(tenc.EncoderFreeSplat(tcfg.encoder), var).eval()
    with torch.no_grad():
        tout = tm({k: _t(a) for k, a in ctx.items()})
    # The slice test's tolerances (tests/test_torch_slice.py): depth maps
    # rtol 1e-3 (depths here run from 1 to 100), the PTF masks on 99.9 %
    # of slots, the Gaussians where both masks hold.
    depth = _n(tout["depth_s-1"])
    assert depth.min() >= 1.0 - 1e-4 and depth.max() <= 100.0 + 1e-2
    for k in ("depth_s-1", "densities", "depth_weights", "depth_s0", "depth_s3"):
        np.testing.assert_allclose(_n(tout[k]), np.asarray(jout[k]), rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    jg, tg = jout["gaussians"], tout["gaussians"]
    jmask, tmask = np.asarray(jg.mask), _n(tg.mask)
    assert (jmask == tmask).mean() >= 0.999
    both = jmask & tmask
    assert both.sum() > 0.5 * both.size
    for f, rtol, atol in (("means", 1e-3, 1e-4), ("covariances", 1e-3, 5e-6),
                          ("harmonics", 1e-3, 1e-4), ("opacities", 1e-3, 1e-4)):
        np.testing.assert_allclose(_n(getattr(tg, f))[both], np.asarray(getattr(jg, f))[both],
                                   rtol=rtol, atol=atol, err_msg=f)


def test_re10k_train_step_matches_jax(chunks):
    """One step of the RE10K preset (MSE; clip 0.05; 2 context and 4
    target views at 32x32) from the same weights: the loss, and Adam's
    first moment after the step, which is 0.1 times the clipped
    gradient."""
    jcfg, tcfg = _re10k_configs("encoder.train_bn=false")
    assert tcfg.optimizer.gradient_clip_val == jcfg.optimizer.gradient_clip_val == 0.05
    batch = _batch(chunks[0])
    arrays = {k: {kk: jnp.asarray(vv) for kk, vv in batch[k].items() if kk != "index"}
              for k in ("context", "target")}
    train = {k: getattr(jcfg, k) for k in ("encoder", "decoder", "loss", "optimizer")}
    jtrain = jtr.TrainCfg(**train)
    jm = jenc.EncoderFreeSplat(jtrain.encoder)
    var = fill_variables(jax.eval_shape(lambda c: jm.init(jax.random.PRNGKey(0), c),
                                        arrays["context"]), seed=1)
    tx = jtr.make_optimizer(jtrain.optimizer)
    jstate = {"params": var["params"], "batch_stats": var["batch_stats"],
              "opt_state": tx.init(var["params"]), "step": jnp.zeros((), jnp.int32)}
    jstate, jm_out = jtr.make_train_step(jtrain, lpips_params=None)(jstate, arrays)

    ttrain = ttr.TrainCfg(**{k: getattr(tcfg, k) for k in train})
    tstate = ttr.init_state(ttrain, seed=0, device="cpu")
    load_flax_variables(tstate["encoder"], var)
    tstate, tm_out = ttr.make_train_step(ttrain, lpips=None)(tstate, batch)
    # The same weights and inputs: measured relative difference 6.6e-7.
    np.testing.assert_allclose(float(tm_out["loss"]), float(jm_out["loss"]), rtol=1e-5)
    assert float(tm_out["dropped_instances"]) == float(jm_out["dropped_instances"]) == 0

    enc, opt = tstate["encoder"], tstate["optimizer"]
    first_moment = {n: opt.state[p]["exp_avg"] for n, p in enc.named_parameters()}
    twin = load_flax_variables(tenc.EncoderFreeSplat(tcfg.encoder), var)
    with torch.no_grad():
        for n, p in twin.named_parameters():
            p.copy_(first_moment[n])
    got = _flat(torch_to_jax_variables(twin)["params"])
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        jstate["opt_state"], is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    want = _flat(jax.tree_util.tree_map(np.asarray, adam.mu))
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    # Clipping was on: the moment's norm is 0.1 x 0.05 in both, up to the
    # float32 sums of the global norm over every parameter (measured 1.6e-4
    # relative in JAX).
    assert np.linalg.norm(b) == pytest.approx(0.005, rel=1e-3)
    assert np.linalg.norm(a) == pytest.approx(0.005, rel=1e-3)
    # The gradients of the two packages agree as the train tests' legs do
    # (running-average BN, ~1e-4 relative; tests/test_torch_train.py):
    # measured 3.0e-4 relative L2 over the moment vector.
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-3


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_run_test_on_a_re10k_chunk_matches_jax(tmp_path):
    """Both harnesses read the first scene of the 2-view RE10K index from
    a chunk of 360x640 JPEGs through their CLI's data routing (the
    preset's evaluation sampler, the crop shim to 32x32) and score it
    under the same weights."""
    key = write_index_scene_chunk(tmp_path / "re10k")
    args = [f"dataset.roots=[{tmp_path / 're10k'}]", f"dataset.evaluation_index_path={INDEX}",
            "test.bn_batch_stats=false"]
    jcfg, _ = _re10k_configs(*args, f"test.output_path={tmp_path / 'jax'}")
    _, tcfg = _re10k_configs(*args, f"test.output_path={tmp_path / 'port'}")
    ctx = {k: jnp.zeros(s, jnp.float32) for k, s in (
        ("image", (1, 2, S, S, 3)), ("extrinsics", (1, 2, 4, 4)), ("intrinsics", (1, 2, 3, 3)),
        ("near", (1, 2)), ("far", (1, 2)))}
    jm = jenc.EncoderFreeSplat(jcfg.encoder)
    var = fill_variables(jax.eval_shape(lambda c: jm.init(jax.random.PRNGKey(0), c), ctx), 3)
    jsum = jax_run_test(jcfg, state=var)
    tsum = run_test(tcfg, state=var, device="cpu")
    stats = json.loads((tmp_path / "port" / "stats.json").read_text())
    (entry,) = stats["per_scene"]
    assert entry["scene"] == key and entry["num_views"] == 3
    # Images from Gaussians that differ by ~1e-4 relative (the slice test);
    # measured PSNR 4.8e-7 dB, SSIM 4.1e-7 apart.
    assert abs(tsum["psnr"] - jsum["psnr"]) <= 1e-4
    assert abs(tsum["ssim"] - jsum["ssim"]) <= 1e-3
    assert tsum["num_gaussians"] == jsum["num_gaussians"]
    assert tsum["dropped_instances"] == jsum["dropped_instances"] == 0


def test_re10k_cli_trains_and_serves_with_the_outputs(tmp_path, monkeypatch, capsys):
    """``main +experiment=re10k/2views`` through the CLI on chunks of
    360x640 JPEGs: 3 train steps with a validation at step 2 that writes
    both videos, then ``mode=test`` on the index scene with the PLY and
    the videos."""
    from freesplat_tpu_torch import main as tmain

    root = tmp_path / "re10k"
    scene = functools.partial(make_scene_dict, n_frames=24, shape=(360, 640), smooth=True)
    write_chunk(root, "train", "000000", [scene("train_a", seed=11), scene("train_b", seed=12)])
    key = write_index_scene_chunk(root)  # test/: the val stage reads it too
    monkeypatch.chdir(tmp_path)  # the logger and validation write under outputs/local
    small = ["+experiment=re10k/2views", f"dataset.roots=[{root}]", "dataset.image_shape=[32,32]",
             "encoder.num_depth_candidates=8", "encoder.adapter.sh_degree=1", "decoder.sh_degree=1"]
    tmain.main([*small, "trainer.max_steps=3", "trainer.val_check_interval=2",
                "trainer.val_save_video=true", "trainer.log_every=1",
                f"checkpointing.output_dir={tmp_path / 'ckpt'}"], device="cpu")
    text = capsys.readouterr().out
    assert "train step 2: loss=" in text and "val step 2: psnr=" in text
    local = tmp_path / "outputs" / "local"
    for name in ("val_0000002_wobble.gif", "val_0000002_interpolation.gif"):
        with Image.open(local / name) as im:
            assert im.n_frames == 30, name
    assert f"step 2 scene {key}" in (local / "val_metrics.txt").read_text()

    out = tmp_path / "test"
    tmain.main([*small, "mode=test", f"dataset.evaluation_index_path={INDEX}",
                f"test.output_path={out}", "test.save_ply=true", "test.save_video=true"],
               device="cpu")
    (entry,) = json.loads((out / "stats.json").read_text())["per_scene"]
    assert entry["scene"] == key and entry["dropped_instances"] == 0
    assert {"gaussians.ply", "wobble.gif", "interpolation.gif"} <= {
        p.name for p in (out / key).iterdir()}
