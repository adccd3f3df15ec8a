"""Free-view training (``scannet/fvt``) on the CPU: one train step of the
port against the benchmark's plain reference (``perfbench/reference/``),
from the same weights and scene.

The setting is the ``fvt8-train`` cell's configuration cut to 32x64 with
8 depth planes, 4 contexts and 2 targets, and nearest-2 cost-volume
sources (``encoder.num_views`` 3), so that the sweep picks its sources
by pose distance and PTF runs three fusion rounds under autograd.  The
step is compared by its loss, each leaf's clipped gradient norm and each
leaf's change; PTF has to merge pixels and the GRU that merges them has
to get a gradient in both, so that PTF's backward is what is compared.
No JAX work: the reference is plain PyTorch.
"""
import pytest
import torch

from perfbench import harness
from perfbench.entries import common
from perfbench.entries.fit_fvt import finite_reference
from perfbench.reference import steps
from perfbench.scenes import make_pool, to_device
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)

SEED = 2**31 + 19


def _cell():
    cell = harness.load_cell("fvt8-train")
    o, tr = cell.config["overrides"], cell.traffic
    o["dataset.image_shape"] = [32, 64]
    o["encoder.num_depth_candidates"] = 8
    o["encoder.num_views"] = 3
    tr.update(context_views=4, target_views=2, pool_scenes=1, gaussians_per_scene=300)
    return cell


def test_fvt_train_step_matches_reference():
    from freesplat_tpu_torch.models.encoder import EncoderFreeSplat
    from freesplat_tpu_torch.training.schedule import make_optimizer
    from freesplat_tpu_torch.training.trainer import TrainCfg, make_train_step

    cell = _cell()
    o = cell.config["overrides"]
    cfg = common.port_config(cell)
    enc_sd, lp_sd = common.draw_weights(cell, SEED, "cpu")
    batch = {k: to_device(make_pool(cell.traffic, o, SEED, "cpu")[0][k], "cpu")
             for k in ("context", "target")}

    port = EncoderFreeSplat(cfg.encoder)
    port.load_state_dict(enc_sd)
    start = {k: v.detach().clone() for k, v in port.named_parameters()}
    state = {"encoder": port.train(), "step": 0,
             "optimizer": make_optimizer(cfg.optimizer, port.parameters())}
    train_cfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                         optimizer=cfg.optimizer)
    _, metrics = make_train_step(train_cfg, common.port_lpips(lp_sd, "cpu"))(state, batch)
    grads = {k: float(p.grad.norm()) for k, p in port.named_parameters()}  # clipped in place
    change = {k: float((p.detach() - start[k]).norm()) for k, p in port.named_parameters()}

    with finite_reference():  # the cell's reference
        ref, ref_lp = common.load_reference(cell, enc_sd, lp_sd, "cpu")
        out = steps.train_steps(ref, ref_lp, o, [batch])

    # PTF merged pixels, and its GRU's gradient is what is compared.
    assert float(metrics["gs_ratio"]) < 0.95
    gru = [k for k in grads if k.startswith("fuse.gru.")]
    assert gru and all(grads[k] > 0 and out["grad_norms"][k] > 0 for k in gru)
    assert float(metrics["dropped_instances"]) == 0

    # The same float32 arithmetic in another order: the loss to rounding.
    assert float(metrics["loss"]) == pytest.approx(out["loss"][0], rel=1e-5)
    # Leaf gradients, each against the larger of its own norm and the
    # median leaf's.  This reads 1.4e-6; batch-statistics BN over 8x16
    # maps amplifies rounding, which moves with the host's convolution
    # algorithms, so the bound leaves two orders of room.
    ref_grads = out["grad_norms"]
    assert common.worst_relative(grads, ref_grads, ref_grads) < 1e-4
    # Adam's first step moves each element by about lr, whatever its
    # gradient's size, so an element whose gradient is at rounding level
    # may step either way: leaves whose gradient is under a thousandth of
    # the median leaf's are left out, as the cell leaves them out.  The
    # rest read 1.1e-5; the bound is the gradient's room again, 1e-3.
    med = sorted(ref_grads.values())[len(ref_grads) // 2]
    moving = [k for k in ref_grads if ref_grads[k] >= 1e-3 * med]
    assert set(gru) <= set(moving)
    assert common.worst_relative(change, out["change_norms"], moving) < 1e-3


def test_extreme_logits_keep_the_gradient_finite():
    """Logits past float32's reach, as 8-context steps meet them: scale
    logits under -88.7 (exp(-x) overflows) and PTF merges whose two
    densities are sigmoids rounded to 0 (a 0 / 0 average).  The forward
    stays finite and the gradient too; at the parent both were NaN."""
    from freesplat_tpu_torch.models.adapter import (GaussianAdapterCfg, build_gaussians,
                                                    scale_multiplier, unproject_depth)
    from freesplat_tpu_torch.models.networks import GRU
    from freesplat_tpu_torch.models.ptf import fuse_views

    cfg = GaussianAdapterCfg(sh_degree=0)
    raw = torch.zeros(4, cfg.d_in)
    raw[:, 0] = torch.tensor([-200.0, -89.0, -81.0, 0.0])
    raw.requires_grad_(True)
    intr = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]])
    out = build_gaussians(cfg, raw, torch.ones(4), torch.eye(3).expand(4, 3, 3), intr, (4, 4))
    floor = cfg.gaussian_scale_min * scale_multiplier(intr, (4, 4))
    torch.testing.assert_close(out["scales"][:3, 0], floor.expand(3), rtol=0, atol=0)
    out["scales"].sum().backward()
    assert torch.isfinite(raw.grad).all()

    # Two 4x4 views from one camera at one depth: every pixel merges, with
    # both densities 0, so each pair is averaged with equal weights.
    hw, c = 16, 8
    depth = torch.full((2, 4, 4), 2.0)
    extr = torch.eye(4).expand(2, 4, 4)
    coords = unproject_depth(depth, intr.expand(2, 3, 3), extr, (4, 4)).reshape(2, hw, 3)
    feats = torch.randn(2, hw, c, requires_grad=True)
    dens = torch.sigmoid(torch.full((2, hw, 1), -200.0, requires_grad=True))
    assert (dens == 0).all()
    state = fuse_views(feats, coords, dens, torch.rand(2, hw, 1), depth.reshape(2, hw),
                       extr, intr.expand(2, 3, 3), (4, 4), GRU(hidden_channel=c))
    assert int(state.valid.sum()) == hw
    torch.testing.assert_close(state.coords[:hw], coords[0], rtol=0, atol=0)
    (state.coords.sum() + state.feat.sum() + state.depth.sum()).backward()
    assert torch.isfinite(feats.grad).all()
