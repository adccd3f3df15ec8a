"""The data the training CLI reads, PyTorch port vs JAX package, on the CPU.

The synthetic stream (both renderers) and the ScanNet loader with its
data module and the Replica loader are held against their JAX
counterparts on the same seeds and fixtures; ``run_test`` without
``batches`` reads the configured dataset and ``checkpointing.load``.  Tolerances are stated beside each check.
"""
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from freesplat_tpu.data import data_module as jdm
from freesplat_tpu.data import replica as jre
from freesplat_tpu.data import scannet as jsc
from freesplat_tpu.data import synthetic as jsyn
from freesplat_tpu.data import view_samplers as jvs
from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch import main as tmain
from freesplat_tpu_torch.data import data_module as tdm
from freesplat_tpu_torch.data import replica as tre
from freesplat_tpu_torch.data import scannet as tsc
from freesplat_tpu_torch.data import synthetic as tsyn
from freesplat_tpu_torch.data import view_samplers as tvs
from freesplat_tpu_torch.evaluation.harness import run_test
from freesplat_tpu_torch.training import checkpoint as ckpt
from freesplat_tpu_torch.training.trainer import TrainCfg, init_state
from tests.test_torch_cli import (  # noqa: F401  (autouse fixture)
    SMALL,
    _one_torch_thread,
    write_replica_scene,
)

VIEW_KEYS = ("image", "depth", "extrinsics", "intrinsics", "near", "far", "index")


# ---------------------------------------------------------------------------
# Synthetic data.


@pytest.mark.parametrize("renderer", ["reference", "tile"])
@pytest.mark.parametrize("size", [32, 64])
def test_synthetic_batches_match_jax(renderer, size):
    kw = dict(image_shape=(size, size), num_context=2, num_target=2, renderer=renderer)
    jit = jsyn.synthetic_batches(jsyn.SyntheticCfg(**kw))
    tit = tsyn.synthetic_batches(tsyn.SyntheticCfg(**kw), device="cpu")
    for _ in range(2):  # the second batch: the same cloud from a fresh camera chain
        jb, tb = next(jit), next(tit)
        assert tb["scene"] == jb["scene"]
        for part in ("context", "target"):
            for k in VIEW_KEYS:
                a, b = np.asarray(jb[part][k]), tb[part][k].numpy()
                assert a.shape == b.shape, (part, k)
                if k in ("image", "depth"):
                    # The rasterizer tests' tolerances (color 2e-5, depth
                    # 2e-4); measured 6e-7 and 2e-6 (covariances built by a
                    # plain matmul here, elementwise in JAX).
                    tol = 2e-5 if k == "image" else 2e-4
                    np.testing.assert_allclose(b, a, atol=tol, err_msg=f"{part} {k}")
                else:  # numpy draws on both sides: exact
                    np.testing.assert_array_equal(b, a, err_msg=f"{part} {k}")
        assert tb["target"]["image"].dtype == torch.float32


# ---------------------------------------------------------------------------
# ScanNet loader.


def _write_scannet_scene(root, n=30):
    """The fixture of tests/test_data.py::test_scannet_loader_fixture."""
    rng = np.random.default_rng(0)
    scene = root / "train" / "scene0000_00"
    (scene / "color").mkdir(parents=True)
    (scene / "depth").mkdir()
    (scene / "intrinsic").mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8), "RGB").save(
            scene / "color" / f"{i}.jpg")
        Image.fromarray(rng.integers(500, 5000, (48, 64), dtype=np.int32), "I").save(
            scene / "depth" / f"{i}.png")
    k = np.array([[80.0, 0, 32, 0], [0, 80, 24, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    np.savetxt(scene / "intrinsic" / "intrinsic_color.txt", k)
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    extr[:, 0, 3] = np.linspace(0, 1, n)
    np.save(scene / "extrinsics.npy", extr)
    (root / "train_idx.txt").write_text("scene0000_00\n")


def _sampler(vs):
    return vs.ViewSamplerBounded(
        vs.ViewSamplerBoundedCfg(
            num_context_views=2,
            min_distance_between_context_views=6,
            max_distance_between_context_views=10,
            initial_min_distance_between_context_views=6,
            initial_max_distance_between_context_views=10,
            min_distance_to_context_views=2,
            warm_up_steps=0,
        ),
        seed=0,
    )


@pytest.mark.parametrize("decoder", ["pil", "native"])
def test_scannet_loader_matches_jax(tmp_path, monkeypatch, decoder):
    """Both loaders decode with PIL (each package's native decoder turned
    off), then both with their native decoders (built from the same
    source with the same flags: the same bits)."""
    import freesplat_tpu.native

    from freesplat_tpu_torch import native as tnative

    if decoder == "pil":
        monkeypatch.setattr(freesplat_tpu.native, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert freesplat_tpu.native.available()
        assert tnative.available(), tnative.build_error()
    assert tnative.decoder_name() == decoder
    _write_scannet_scene(tmp_path)
    (tmp_path / "test").symlink_to(tmp_path / "train")  # the val stage reads test/
    kw = dict(roots=(str(tmp_path),), image_shape=(32, 48), load_size=(48, 64))
    jds = jsc.DatasetScannet(jsc.DatasetScannetCfg(**kw), "train", _sampler(jvs))
    tds = tsc.DatasetScannet(tsc.DatasetScannetCfg(**kw), "train", _sampler(tvs))
    assert len(tds) == len(jds) == 1
    pairs = [(jds[0], tds[0])]
    # Then through the data modules (collate, epoch order, the step hook).
    modules = [
        dm_mod.DataModule(lambda stage, m=m, vs=vs: m.DatasetScannet(
            m.DatasetScannetCfg(**kw), stage, _sampler(vs)), step_fn=lambda: 0, prefetch=0)
        for dm_mod, m, vs in ((jdm, jsc, jvs), (tdm, tsc, tvs))
    ]
    for stage in ("train_batches", "val_batches"):
        pairs.append(tuple(next(getattr(m, stage)()) for m in modules))
    for je, te in pairs:
        assert te["scene"] == je["scene"]
        for part in ("context", "target"):
            assert set(te[part]) == set(je[part])
            for k in je[part]:  # the same decoder on both sides: equal arrays
                np.testing.assert_array_equal(np.asarray(te[part][k]), np.asarray(je[part][k]),
                                              err_msg=f"{part} {k}")
    te = pairs[1][1]
    assert te["context"]["image"].shape == (1, 2, 32, 48, 3)
    assert te["context"]["depth_s0"].shape == (1, 2, 16, 24)



def test_replica_loader_matches_jax(tmp_path):
    """``DatasetReplica`` of both packages on a Replica-layout scene: the
    suffixed index key ``office0_1`` read from ``office0``, the
    extrapolation targets last with ``test_fvs``, ``depth_intrinsics``
    normalized by the depth image's own size; every array equal.  Then
    the port's CLI routing (``make_batches`` with ``dataset.name=replica``)
    gives the same batch.  Both packages decode with their native decoders
    (the same bits)."""
    index = write_replica_scene(tmp_path)
    kw = dict(roots=(str(tmp_path),), image_shape=(32, 48), load_size=(48, 64))

    def sampler(vs):
        return vs.ViewSamplerEvaluation(vs.ViewSamplerEvaluationCfg(index_path=str(index)))

    jds = jre.DatasetReplica(jsc.DatasetScannetCfg(**kw), "test", sampler(jvs))
    tds = tre.DatasetReplica(tsc.DatasetScannetCfg(**kw), "test", sampler(tvs))
    assert len(tds) == len(jds) == 1
    je, te = jds[0], tds[0]
    assert te["scene"] == je["scene"] == "office0_1"
    assert te["target"]["test_fvs"] == je["target"]["test_fvs"] == 2
    for part in ("context", "target"):
        assert set(te[part]) == set(je[part])
        assert "depth_intrinsics" in te[part]
        for k in je[part]:  # the same decoder on both sides: equal arrays
            np.testing.assert_array_equal(np.asarray(te[part][k]), np.asarray(je[part][k]),
                                          err_msg=f"{part} {k}")
    np.testing.assert_array_equal(te["target"]["index"], [2, 4, 9, 11])
    np.testing.assert_allclose(te["context"]["depth_intrinsics"][0, :2, :],
                               [[40 / 32, 0, 16 / 32], [0, 40 / 24, 12 / 24]], rtol=1e-6)

    cfg = load_config(["+experiment=replica/2views", f"dataset.roots=[{tmp_path}]",
                       f"dataset.evaluation_index_path={index}"])
    assert isinstance(tmain.make_data_module(cfg).dataset_factory("test"), tre.DatasetReplica)
    batch = next(tmain.make_batches(cfg, "test", device="cpu"))
    jbatch = jsc.collate([jre.DatasetReplica(
        jsc.DatasetScannetCfg(roots=(str(tmp_path),), image_shape=(384, 512)), "test",
        sampler(jvs))[0]])
    assert batch["scene"] == jbatch["scene"]
    for part in ("context", "target"):
        assert set(batch[part]) == set(jbatch[part])
        for k in jbatch[part]:
            np.testing.assert_array_equal(np.asarray(batch[part][k]), np.asarray(jbatch[part][k]),
                                          err_msg=f"CLI {part} {k}")


# ---------------------------------------------------------------------------
# The test harness.


def test_run_test_reads_the_configured_dataset(tmp_path):
    """Without ``batches`` run_test reads the dataset through
    ``main.make_batches``: 4 scenes of the infinite synthetic stream; with
    ``checkpointing.load`` and no ``state`` it evaluates the checkpoint."""
    cfg = load_config([*SMALL, "mode=test", "test.save_depth=false", "test.eval_depth=false",
                       f"test.output_path={tmp_path / 'out'}"])
    timings = {}
    summary = run_test(cfg, device="cpu", timings=timings)
    assert len(timings["encoder_s"]) == 4
    assert np.isfinite(summary["psnr"]) and summary["dropped_instances"] == 0

    state = init_state(TrainCfg(encoder=cfg.encoder), seed=5, device="cpu")
    ckpt.save_checkpoint(str(tmp_path), 9, state)
    loaded = dataclasses.replace(
        cfg, checkpointing=dataclasses.replace(cfg.checkpointing, load=str(tmp_path)))
    from_ckpt = run_test(loaded, device="cpu", max_scenes=1)
    # Seed 5, not cfg.seed: equal only if the checkpoint was read.
    assert from_ckpt == run_test(cfg, state=state["encoder"].state_dict(), device="cpu",
                                 max_scenes=1)
    # The synthetic targets carry depth: with eval_depth the rendered
    # depth is scored against it.
    assert not any(k.startswith("depth_") for k in summary)
    with_depth = run_test(
        dataclasses.replace(cfg, test=dataclasses.replace(cfg.test, eval_depth=True)),
        device="cpu", max_scenes=1)
    assert {"depth_abs_diff", "depth_abs_rel", "depth_delta_25", "depth_delta_10"} <= set(
        with_depth)
    assert all(np.isfinite(v) for v in with_depth.values())
