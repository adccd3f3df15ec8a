"""The training entry point of the PyTorch port vs the JAX package, on the CPU.

Validation is held against JAX's on the same (bridged) weights; the
checkpoint is held to a round trip, a partial restore and a resumed run
that equals the uninterrupted one; ``main`` trains, checkpoints, validates
and resumes through the CLI, and evaluates a Replica-layout scene.  The data it reads is checked in
``tests/test_torch_data.py``.  Tolerances are stated beside each check.
The JAX CLI itself is not run (its test is marked slow).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.models.adapter import GaussianAdapterCfg as JAdapterCfg
from freesplat_tpu.models.decoder import DecoderCfg as JDecoderCfg
from freesplat_tpu.training.validation import validation_step as jax_validation_step
from freesplat_tpu_torch import main as tmain
from freesplat_tpu_torch.data import synthetic as tsyn
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models.adapter import GaussianAdapterCfg as TAdapterCfg
from freesplat_tpu_torch.models.backbone import BatchNorm
from freesplat_tpu_torch.models.decoder import DecoderCfg as TDecoderCfg
from freesplat_tpu_torch.training import checkpoint as ckpt
from freesplat_tpu_torch.training.trainer import TrainCfg, fit, init_state
from freesplat_tpu_torch.training.validation import validation_step
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_encoder import fill_variables
from tests.test_torch_slice import make_scene
from tests.test_torch_visualizers import jit_jax_panels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the tier-1 run shares the
    cores among several test workers, and torch's thread pool then waits
    on preempted threads at every one of the many small ops of a CPU
    train step (a 13 s test here took 420 s beside the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The overrides of tests/test_main_cli.py's training run.
SMALL = [
    "dataset.name=synthetic",
    "dataset.image_shape=[32,32]",
    "encoder.num_depth_candidates=8",
    "encoder.adapter.sh_degree=1",
    "encoder.train_bn=false",
    "decoder.sh_degree=1",
    "trainer.log_every=1",
    "optimizer.warm_up_steps=2",
    "optimizer.max_steps=10",
    "optimizer.gradient_clip_val=1.0",
]


# ---------------------------------------------------------------------------
# Checkpoints.


class _Toy(torch.nn.Module):
    def __init__(self, out=3):
        super().__init__()
        self.w = torch.nn.Linear(2, out)
        self.bn = BatchNorm(4, use_running_average=False)


def _toy_state(out=3, fill=None, step=0):
    m = _Toy(out)
    if fill is not None:
        with torch.no_grad():
            for t in list(m.parameters()) + list(m.buffers()):
                t.fill_(fill)
    return {"encoder": m, "optimizer": torch.optim.Adam(m.parameters(), lr=0.1), "step": step}


def test_checkpoint_roundtrip_and_partial(tmp_path):
    state = _toy_state()
    with torch.no_grad():
        state["encoder"].w.weight.copy_(torch.arange(6.0).reshape(3, 2))
        state["encoder"].bn.running_mean.fill_(0.25)
    state["encoder"].w(torch.ones(1, 2)).sum().backward()
    state["optimizer"].step()  # Adam moments to save
    state["step"] = 7
    ckpt.save_checkpoint(str(tmp_path), 7, state)
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert ckpt.latest_step(str(tmp_path / "missing")) is None

    ref = _toy_state(fill=0.0)
    restored = ckpt.restore_checkpoint(str(tmp_path), 7, ref, strict=True)
    assert restored["step"] == 7
    for (k, a), (_, b) in zip(state["encoder"].state_dict().items(),
                              ref["encoder"].state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    sa, sb = state["optimizer"].state_dict(), ref["optimizer"].state_dict()
    for i in sa["state"]:
        for k in sa["state"][i]:
            torch.testing.assert_close(sb["state"][i][k], sa["state"][i][k], rtol=0, atol=0)

    # Partial restore: a reshaped parameter keeps its fresh value, the
    # matching ones are grafted, and the optimizer stays fresh.
    ref2 = _toy_state(out=4, fill=-1.0)
    restored2 = ckpt.restore_checkpoint(str(tmp_path), 7, ref2, strict=False)
    enc = ref2["encoder"]
    assert torch.all(enc.w.weight == -1.0) and torch.all(enc.w.bias == -1.0)
    assert torch.all(enc.bn.running_mean == 0.25)
    assert torch.equal(enc.bn.weight, state["encoder"].bn.weight)
    assert ref2["optimizer"].state_dict()["state"] == {}
    assert restored2["step"] == 7
    with pytest.raises(RuntimeError, match="size mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), 7, _toy_state(out=4), strict=True)


def test_resume_equals_continue(tmp_path):
    """Save after step 2 as fit does, restore into a fresh state, run on:
    the same parameters, BN buffers, Adam moments and losses as the run
    that was never interrupted.  On the CPU both runs do the same float
    operations in the same order, so they agree exactly."""
    cfg = TrainCfg(
        encoder=tenc.EncoderFreeSplatCfg(num_depth_candidates=8, adapter=TAdapterCfg(sh_degree=1)),
        decoder=TDecoderCfg(sh_degree=1), log_every=1,
    )
    stream = tsyn.synthetic_batches(tsyn.SyntheticCfg(image_shape=(32, 32)), device="cpu")
    batches = [next(stream) for _ in range(4)]

    logged_a, logged_b = {}, {}
    state_a = fit(cfg, init_state(cfg, seed=3, device="cpu"), iter(batches), 4,
                  log_fn=logged_a.__setitem__, checkpoint_every=2,
                  checkpoint_fn=lambda s, st: ckpt.save_checkpoint(str(tmp_path), s, st))
    assert ckpt.latest_step(str(tmp_path)) == 2
    state_b = ckpt.restore_checkpoint(str(tmp_path), 2, init_state(cfg, seed=3, device="cpu"))
    assert state_b["step"] == 3  # the state after step 2, as fit saves it
    state_b = fit(cfg, state_b, iter(batches[3:]), 4, log_fn=logged_b.__setitem__)
    assert state_a["step"] == state_b["step"] == 4
    assert sorted(logged_b) == [3]
    for k, v in logged_b[3].items():
        if k != "steps_per_s":
            assert v == logged_a[3][k], k
    sd_a, sd_b = state_a["encoder"].state_dict(), state_b["encoder"].state_dict()
    for k in sd_a:
        torch.testing.assert_close(sd_b[k], sd_a[k], rtol=0, atol=0, msg=k)
    oa, ob = state_a["optimizer"].state_dict()["state"], state_b["optimizer"].state_dict()["state"]
    for i in oa:
        for k in oa[i]:
            torch.testing.assert_close(ob[i][k], oa[i][k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Validation.


# save_projections' panels against JAX's, as written (uint8): (largest
# difference, share of values that differ).  The cameras are drawn from the
# batch alone and equal.  The depth and Gaussian panels color the encoder's
# outputs, which batch-statistics BN at 64x64 moves by ~1e-4: a value on
# a colormap row's edge moves one row, up to 4 levels of turbo or inferno
# (measured 3 and 2, on 0.017 % and 0.020 % of the values).  The epipolar
# samples sit ~1e-7 apart (measured 1 on 0.002 %), and the projections go
# through the tile compositor on each side (measured 1 on 0.08 %).
PANEL_TOLERANCE = {"cameras": (0, 0.0), "depth": (4, 1e-3), "gaussians": (4, 1e-3),
                   "epipolar": (1, 1e-3), "projections": (1, 5e-3)}


def test_validation_step_matches_jax(tmp_path, monkeypatch):
    batch = make_scene(3)
    jcfg = jenc.EncoderFreeSplatCfg(num_depth_candidates=8, adapter=JAdapterCfg(sh_degree=2))
    jm = jenc.EncoderFreeSplat(jcfg)
    jctx = {k: jnp.asarray(a) for k, a in batch["context"].items()}
    var = fill_variables(jax.eval_shape(lambda c: jm.init(jax.random.PRNGKey(0), c), jctx), seed=4)
    # The JAX side renders with its dense reference compositor: its tile
    # rasterizer runs eagerly in Pallas interpret mode (~30 s here).  Its
    # save_projections panels run the epipolar sampler and the Pallas
    # rasterizer (the projections) jitted.
    jit_jax_panels(monkeypatch)
    jpsnr = jax_validation_step(jcfg, JDecoderCfg(sh_degree=2, use_reference_rasterizer=True),
                                var, batch, 7, output_dir=tmp_path / "jax",
                                save_projections=True)["psnr"]
    jgrid = np.asarray(Image.open(tmp_path / "jax" / "val_0000007.png")).astype(int)
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert names == [f"val_0000007{s}.png" for s in
                     ("", "_cameras", "_depth", "_epipolar", "_gaussians", "_projections")]

    for train_bn in (True, False):
        tcfg = tenc.EncoderFreeSplatCfg(num_depth_candidates=8, adapter=TAdapterCfg(sh_degree=2),
                                        train_bn=train_bn)
        enc = load_flax_variables(tenc.EncoderFreeSplat(tcfg), var).train()
        before = {k: v.clone() for k, v in enc.state_dict().items()}
        for use_ref in (True, False) if train_bn else (False,):
            out = tmp_path / f"torch_{train_bn}_{use_ref}"
            dcfg = TDecoderCfg(sh_degree=2, use_reference_rasterizer=use_ref)
            projections = train_bn and not use_ref
            psnr = validation_step(tcfg, dcfg, enc, batch, 7, output_dir=out,
                                   save_projections=projections)["psnr"]
            # Batch-statistics BN over 2 images of 64x64 amplifies float32
            # rounding (ROADMAP §3) and the tile compositor is held to 2e-5
            # against the dense one: measured 3.5e-5 dB.
            assert abs(psnr - jpsnr) <= 1e-3, (train_bn, use_ref, psnr, jpsnr)
            grid = np.asarray(Image.open(out / "val_0000007.png")).astype(int)
            assert grid.shape == jgrid.shape
            assert np.abs(grid - jgrid).max() <= 1  # uint8 rounding of close values
            line = (out / "val_metrics.txt").read_text()
            assert line.startswith("step 7 scene scene3 psnr ")
            if projections:
                assert sorted(p.name for p in out.glob("*.png")) == names
                for name in names[1:]:
                    a = np.asarray(Image.open(out / name)).astype(int)
                    b = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
                    assert a.shape == b.shape, name
                    d = np.abs(a - b)
                    most, share = PANEL_TOLERANCE[name.split("_")[-1][:-4]]
                    assert d.max() <= most and (d > 0).mean() <= share, (name, d.max(),
                                                                         (d > 0).mean())
        # The training encoder: buffers and train() mode as before.
        assert enc.training
        for k, v in enc.state_dict().items():
            assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# The CLI.


def test_train_cli_checkpoints_validates_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the logger and validation write under outputs/local
    out = str(tmp_path / "ckpt")
    tmain.main([*SMALL, "trainer.max_steps=3", "trainer.val_check_interval=2",
                f"checkpointing.output_dir={out}", "checkpointing.every_n_train_steps=2"],
               device="cpu")
    text = capsys.readouterr().out
    for step in range(3):
        assert f"train step {step}: loss=" in text
    assert "psnr" in text and "val step 2: psnr=" in text
    assert (tmp_path / "ckpt" / "step_2" / "state.pt").exists()
    assert (tmp_path / "outputs" / "local" / "val_0000002.png").exists()
    assert "step 2 scene synthetic_0" in (tmp_path / "outputs/local/val_metrics.txt").read_text()

    tmain.main([*SMALL, "trainer.max_steps=4", f"checkpointing.load={out}",
                f"checkpointing.output_dir={tmp_path / 'ckpt2'}"], device="cpu")
    text = capsys.readouterr().out
    assert "restored checkpoint step 2" in text
    assert "train step 3: loss=" in text and "train step 2:" not in text


def write_replica_scene(root, n=12, seed=3):
    """A Replica-layout scene (the fixture of tests/test_data.py::
    test_replica_loader_fvs_fixture): ``test/office0`` with 48x64 color,
    24x32 depth (the depth camera has its own size and calibration), a
    test index that lists the suffixed key ``office0_1``, and an
    evaluation index with two extrapolation targets.  Returns the index
    path."""
    rng = np.random.default_rng(seed)
    scene = root / "test" / "office0"
    for sub in ("color", "depth", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8), "RGB").save(
            scene / "color" / f"{i}.jpg")
        Image.fromarray(rng.integers(500, 5000, (24, 32), dtype=np.int32), "I").save(
            scene / "depth" / f"{i}.png")
    np.savetxt(scene / "intrinsic" / "intrinsic_color.txt",
               np.array([[80.0, 0, 32, 0], [0, 80, 24, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    np.savetxt(scene / "intrinsic" / "intrinsic_depth.txt",
               np.array([[40.0, 0, 16, 0], [0, 40, 12, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    extr[:, 0, 3] = np.linspace(0, 1, n)
    np.save(scene / "extrinsics.npy", extr)
    (root / "test_idx.txt").write_text("office0_1\n")
    index = root / "evaluation_index_replica.json"
    index.write_text(json.dumps(
        {"office0_1": {"context": [0, 6], "target": [2, 4], "extrapolation": [9, 11]}}))
    return index


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    """Everything here is ported and runs.  ``trainer.devices`` (multi-
    device training): ``trainer.devices=1`` trains one step in this
    process, and ``trainer.devices=2`` asks for a launch of two processes
    (torchrun), so one process raises naming its world size; the 2-rank
    run is in ``tests/test_torch_ddp.py``.  ``re10k`` and ``replica``:
    ``main`` evaluates the first scene of the RE10K 2-view index from a
    chunk of 360x640 JPEGs, and a Replica scene with the preset's defaults
    (the FVS-split stats and frames)."""
    from tests.test_torch_re10k import INDEX, write_index_scene_chunk

    monkeypatch.chdir(tmp_path)  # the logger writes under outputs/local
    tmain.main([*SMALL, "trainer.devices=1", "trainer.max_steps=1"], device="cpu")
    assert "train step 0: loss=" in capsys.readouterr().out
    with pytest.raises(ValueError, match="world size is 1.*torchrun --nproc_per_node 2"):
        tmain.main([*SMALL, "trainer.devices=2"], device="cpu")
    key = write_index_scene_chunk(tmp_path / "re10k")
    tmain.main(["+experiment=re10k/2views", "mode=test", f"dataset.roots=[{tmp_path / 're10k'}]",
                f"dataset.evaluation_index_path={INDEX}",
                f"test.output_path={tmp_path / 're10k_out'}",
                *[a for a in SMALL if not a.startswith(("dataset.name", "trainer."))]],
               device="cpu")
    (scene,) = json.loads((tmp_path / "re10k_out" / "stats.json").read_text())["per_scene"]
    assert scene["scene"] == key and scene["num_views"] == 3 and np.isfinite(scene["psnr"])

    index = write_replica_scene(tmp_path / "replica")
    out = tmp_path / "out"
    tmain.main(["+experiment=replica/2views", f"dataset.roots=[{tmp_path / 'replica'}]",
                f"dataset.evaluation_index_path={index}", f"test.output_path={out}",
                *[a for a in SMALL if not a.startswith(("dataset.name", "trainer."))]],
               device="cpu")
    stats = json.loads((out / "stats.json").read_text())
    (scene,) = stats["per_scene"]
    assert scene["scene"] == "office0_1" and scene["num_views"] == 4
    for k in ("interpolation_psnr", "extrapolation_ssim", "depth_abs_rel"):
        assert np.isfinite(scene[k]), k
    assert {p.name for p in (out / "office0_1").iterdir()} == {
        "interpolation", "extrapolation", "context", "depth_pred", "depth_render"}
    assert (out / "office0_1" / "extrapolation" / "0003_gt.png").exists()
