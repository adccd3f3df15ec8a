"""A whole run on the CPU, past the look for a chip, with the timed path
broken underneath: ``correct`` has to come out false for each fault the
cell can have, and true without one.  At 32x64 the training cell's gaps
are wider than on the card (batch statistics over tiny maps amplify
rounding through Adam's first steps), so its limits here are the CPU's:
loss 1e-2, gradient 1e-3, change 0.1.  The whole-scene cell keeps its own.
No cell spans chips, so no exchange between chips can be left out."""
import time

import pytest
import torch

from perfbench import calibrate
from perfbench.run import run_cell

SEED = 2**31 + 101
CPU_TRAIN_LIMITS = {"loss_rel": 1e-2, "grad_rel": 1e-3, "change_rel": 0.1}


def _run(cell):
    return run_cell(cell, SEED, 0.5, False, "cpu", t_start=time.perf_counter())


def _half_loss(total_loss):
    def loss(cfg, pred, target, *args, **kw):  # the mean over the first half of the views
        n = pred.shape[1] // 2
        return total_loss(cfg, pred[:, :n], target[:, :n], *args, **kw)
    return loss


def _altered(render_views):
    def render(*args, **kw):  # the first view's colour brightened where it is produced
        out = render_views(*args, **kw)
        return out._replace(color=torch.cat([out.color[:, :1] + 0.1, out.color[:, 1:]], 1))
    return render


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
def test_train_cell(fault, small_cell, monkeypatch):
    from freesplat_tpu_torch.training import trainer

    if fault == "unchanged":  # a step that returns its state unchanged
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(trainer, "total_loss", _half_loss(trainer.total_loss))
    elif fault == "altered":
        monkeypatch.setattr(trainer, "render_views", _altered(trainer.render_views))
    cell = small_cell("scannet2v-train")
    cell.workload["limits"] = CPU_TRAIN_LIMITS
    run = _run(cell)
    assert run.correct == (fault is None), [(c.name, c.value) for c in run.checks]


@pytest.mark.parametrize("fault", [None, "half_batch", "altered"])
def test_whole_scene_cell(fault, small_cell, monkeypatch):
    from freesplat_tpu_torch.evaluation import harness as port_harness

    if fault == "half_batch":  # the scene encoded from the first half of its views
        make = port_harness.make_chunked_encode

        def half(encoder, *args, **kw):
            encode = make(encoder, *args, **kw)

            def run(context):
                n = context["image"].shape[1] // 2
                return encode({k: v[:, :n] for k, v in context.items()})
            return run
        monkeypatch.setattr(port_harness, "make_chunked_encode", half)
    elif fault == "altered":
        monkeypatch.setattr(port_harness, "render_views", _altered(port_harness.render_views))
    run = _run(small_cell("fvt-wholescene30"))
    assert run.correct == (fault is None), [(c.name, c.value) for c in run.checks]
    assert run.attempted >= 1 and run.failed == 0


def test_calibration_faults_fail_the_train_cell(small_cell, tmp_path):
    """``calibrate.py``'s faults, planted in the reference, read as the run
    compares the program (no TF32 on the CPU, so its control reads as the
    reference)."""
    cell = small_cell("scannet2v-train")
    got = dict(calibrate.readings(cell, SEED, "cpu", tmp_path))
    assert set(got) == {"tf32", "half_batch", "altered"}
    for fault in ("half_batch", "altered"):
        assert any(got[fault][k] > CPU_TRAIN_LIMITS[k] for k in CPU_TRAIN_LIMITS), got[fault]
