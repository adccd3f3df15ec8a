"""The free-view training cell (``fvt8-train``): its reference against the
port at 32x64 with 8 depth planes (8 contexts, nearest-4 sources, PTF
with gradients), the reference's held scale logits, a traced run on the
CPU, and on the card the control and a short run."""
import importlib
import time

import pytest
import torch

from perfbench import calibrate_fvt, harness
from perfbench.entries import common
from perfbench.entries import fit_fvt
from perfbench.entries.fit_fvt import finite_reference
from perfbench.reference import finite_backward, steps
from perfbench.reference.model import EncoderSizes
from perfbench.run import result_line, run_cell
from perfbench.scenes import make_pool, to_device

SEED = 2**31 + 23
CELL = "fvt8-train"


def _setup(small_cell):
    from freesplat_tpu_torch.models.encoder import EncoderFreeSplat

    cell = small_cell(CELL)
    cfg = common.port_config(cell)
    enc_sd, lp_sd = common.draw_weights(cell, SEED, "cpu")
    with finite_reference():
        ref, ref_lp = common.load_reference(cell, enc_sd, lp_sd, "cpu")
    port = EncoderFreeSplat(cfg.encoder)
    port.load_state_dict(enc_sd)
    pool = make_pool(cell.traffic, cell.config["overrides"], SEED, "cpu")
    batch = {k: to_device(pool[0][k], "cpu") for k in ("context", "target")}
    return cell, cfg, port, ref, ref_lp, lp_sd, batch


def test_gaussians_with_gradients(small_cell):
    """The training path's Gaussians (autograd on: PTF works on copies)."""
    _, _, port, ref, _, _, batch = _setup(small_cell)
    g_port = port.train()(batch["context"])["gaussians"]
    g_ref = ref.encode(batch["context"])
    mask = g_ref["mask"]
    assert torch.equal(g_port.mask[0], mask) and 0 < int(mask.sum()) < mask.numel()
    for name in ("means", "covariances", "harmonics", "opacities"):
        got, want = getattr(g_port, name)[0][mask], g_ref[name][mask]
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-6), name


def test_one_train_step(small_cell):
    from freesplat_tpu_torch.training.schedule import make_optimizer
    from freesplat_tpu_torch.training.trainer import TrainCfg, make_train_step

    cell, cfg, port, ref, ref_lp, lp_sd, batch = _setup(small_cell)
    train_cfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                         optimizer=cfg.optimizer)
    start = {k: v.detach().clone() for k, v in port.named_parameters()}
    state = {"encoder": port.train(), "step": 0,
             "optimizer": make_optimizer(cfg.optimizer, port.parameters())}
    _, metrics = make_train_step(train_cfg, common.port_lpips(lp_sd, "cpu"))(state, batch)
    out = steps.train_steps(ref, ref_lp, cell.config["overrides"], [batch])
    assert float(metrics["loss"]) == pytest.approx(out["loss"][0], rel=1e-5)
    grads = out["grad_norms"]
    assert all(grads[k] > 0 for k in grads if k.startswith("fuse.gru."))
    moving = [k for k in grads if grads[k] >= 1e-3 * sorted(grads.values())[len(grads) // 2]]
    change = {k: float((p.detach() - start[k]).norm()) for k, p in port.named_parameters()}
    # Adam's first step: elements at rounding level may step either way
    # (``test_perfbench_reference.py::test_one_train_step``).
    assert common.worst_relative(change, out["change_norms"], moving) < 1e-3


def test_held_scale_logits():
    """Below -88.7 the frozen scale's backward is NaN; held, the same
    scales and a finite gradient.  Above the floor nothing changes."""
    sizes = EncoderSizes.from_overrides(harness.load_cell(CELL).config["overrides"])
    head = torch.nn.Module()  # an encoder's head alone, its output the raw logits
    head.fuse = torch.nn.Module()
    head.fuse.to_gaussians = torch.nn.Identity()
    finite_backward.hold(head)
    raw = torch.tensor([[0.3, -1.0, -100.0, -89.0, -2.0, 1.0],
                        [0.1, 0.2, 5.0, -79.0, 80.0, -3.0]], requires_grad=True)
    held = head.fuse.to_gaussians(raw)
    lo, hi = sizes.gaussian_scale_min, sizes.gaussian_scale_max
    frozen = lo + (hi - lo) * (1.0 / (1.0 + torch.exp(-raw[:, 2:5])))
    scales = lo + (hi - lo) * (1.0 / (1.0 + torch.exp(-held[:, 2:5])))
    assert torch.equal(scales, frozen)
    assert torch.equal(held[1], raw[1]) and torch.equal(held[:, [0, 1, 5]], raw[:, [0, 1, 5]])
    (grad,) = torch.autograd.grad(frozen.sum(), raw)
    assert torch.isnan(grad[0, 2:4]).all()
    (grad,) = torch.autograd.grad(scales.sum(), raw)
    assert torch.isfinite(grad).all() and (grad[0, 2:4] == 0).all()


def test_traced_run_reports_the_cell_metrics(small_cell):
    cell = small_cell(CELL)
    run = run_cell(cell, SEED, 0.5, True, "cpu", t_start=time.perf_counter())
    line = result_line(cell, run, True, "cpu")
    assert line["correct"], line["checks"]
    assert {"backward_ms.train", "optimizer_ms.train", "idle_share.train", "mfu.train",
            "ptf_ms.train", "ptf_bwd_ms.train"} <= set(line["metrics"])


def test_calibration_faults_fail_the_cell(small_cell, tmp_path):
    """``calibrate_fvt.py``'s readings: the faults exceed the cell's limits
    (no TF32 on the CPU, so the control reads as the reference)."""
    cell = small_cell(CELL)
    limits = cell.workload["limits"]
    got = dict(calibrate_fvt.readings(cell, SEED, "cpu", tmp_path))
    assert set(got) == {"tf32", "half_batch", "altered"}
    for fault in ("half_batch", "altered"):
        assert any(got[fault][k] > limits[k] for k in limits), got[fault]


@pytest.mark.parametrize("guard", ["adapter.SCALE_LOGIT_MIN", "ptf.DENSITY_FLOOR"])
def test_program_without_a_guard_is_refused(small_cell, monkeypatch, guard):
    """A program without one of the reference's guards fails before set-up."""
    module, name = guard.split(".")
    monkeypatch.delattr(importlib.import_module(f"freesplat_tpu_torch.models.{module}"), name)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=name):
        fit_fvt.run(small_cell(CELL), SEED, 0.5, False, "cpu", t0)
    assert time.perf_counter() - t0 < 5.0


@pytest.mark.chip
def test_control_comes_out_not_correct(cuda_device, tmp_path):
    cell = harness.load_cell(CELL)
    limits = cell.workload["limits"]
    control = dict(calibrate_fvt.readings(cell, 2**31 + 311, cuda_device, tmp_path))["tf32"]
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.chip
def test_short_run_is_correct(cuda_device):
    run = run_cell(harness.load_cell(CELL), 2**31 + 312, 5.0, False, cuda_device,
                   t_start=time.perf_counter())
    assert run.correct and run.failed == 0, [(c.name, c.value) for c in run.checks]
