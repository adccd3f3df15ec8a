"""The frozen reference against the port, on the same weights and scenes,
at 32x64 with 8 depth planes: the Gaussians, the rendered color and depth,
one train step's loss and update, and the chunked whole-scene encode."""
import pytest
import torch

from perfbench.entries import common
from perfbench.reference import steps
from perfbench.reference.render import render_view
from perfbench.scenes import make_pool, to_device

SEED = 2**31 + 17


def _setup(small_cell, name):
    from freesplat_tpu_torch.models.encoder import EncoderFreeSplat

    cell = small_cell(name)
    cfg = common.port_config(cell)
    enc_sd, lp_sd = common.draw_weights(cell, SEED, "cpu")
    ref, ref_lp = common.load_reference(cell, enc_sd, lp_sd, "cpu")
    port = EncoderFreeSplat(cfg.encoder)
    port.load_state_dict(enc_sd)
    pool = make_pool(cell.traffic, cell.config["overrides"], SEED, "cpu")
    batch = {k: to_device(pool[0][k], "cpu") for k in ("context", "target")}
    return cell, cfg, port, ref, ref_lp, lp_sd, batch


def _same_gaussians(g_port, g_ref):
    mask = g_ref["mask"]
    assert torch.equal(g_port.mask[0], mask)
    for name in ("means", "covariances", "harmonics", "opacities"):
        got, want = getattr(g_port, name)[0][mask], g_ref[name][mask]
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-6), name


def test_gaussians_and_renders(small_cell):
    from freesplat_tpu_torch.models.decoder import render_views

    cell, cfg, port, ref, _, _, batch = _setup(small_cell, "scannet2v-train")
    with torch.no_grad():
        g_port = port.train()(batch["context"])["gaussians"]
        g_ref = ref.encode(batch["context"])
        _same_gaussians(g_port, g_ref)
        tgt = batch["target"]
        out = render_views(cfg.decoder, g_port, tgt["extrinsics"], tgt["intrinsics"],
                           tgt["near"], tgt["far"], tuple(tgt["image"].shape[2:4]))
        for i in range(tgt["image"].shape[1]):
            color, depth = render_view(g_ref, tgt["extrinsics"][0, i], tgt["intrinsics"][0, i],
                                       tgt["near"][0, i], tuple(tgt["image"].shape[2:4]),
                                       ref.sizes.sh_degree)
            assert torch.allclose(out.color[0, i], color, atol=2e-5)
            assert torch.allclose(out.depth[0, i], depth, rtol=1e-4, atol=1e-4)


def test_one_train_step(small_cell):
    from freesplat_tpu_torch.training.schedule import make_optimizer
    from freesplat_tpu_torch.training.trainer import TrainCfg, make_train_step

    cell, cfg, port, ref, ref_lp, lp_sd, batch = _setup(small_cell, "scannet2v-train")
    train_cfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                         optimizer=cfg.optimizer)
    start = {k: v.clone() for k, v in port.named_parameters()}
    state = {"encoder": port.train(), "step": 0,
             "optimizer": make_optimizer(cfg.optimizer, port.parameters())}
    _, metrics = make_train_step(train_cfg, common.port_lpips(lp_sd, "cpu"))(state, batch)
    out = steps.train_steps(ref, ref_lp, cell.config["overrides"], [batch])
    assert float(metrics["loss"]) == pytest.approx(out["loss"][0], rel=1e-5)
    # Adam's first step moves every element by about lr, so an element
    # whose gradient is at rounding level may step either way: a few do.
    # Each leaf's change agrees in norm, and all of them as one vector;
    # leaves whose gradient is nought to rounding (under a thousandth of the
    # median leaf's, as a bias before a batch norm) move by round-off alone.
    refp = dict(ref.named_parameters())
    grads = out["grad_norms"]
    floor = 1e-3 * sorted(grads.values())[len(grads) // 2]
    got, want = [], []
    for name, p in port.named_parameters():
        if grads[name] < floor:
            continue
        change = (p.detach() - start[name]).norm()
        assert float(change) == pytest.approx(out["change_norms"][name], rel=1e-3, abs=1e-12), name
        got.append((p.detach() - start[name]).flatten())
        want.append((refp[name].detach() - start[name]).flatten())
    got, want = torch.cat(got), torch.cat(want)
    assert float((got - want).norm() / want.norm()) < 0.05


def test_chunked_whole_scene_encode(small_cell):
    from freesplat_tpu_torch.evaluation.harness import make_chunked_encode

    cell, cfg, port, ref, _, _, batch = _setup(small_cell, "fvt-wholescene30")
    chunk = cell.config["overrides"]["test.encode_view_chunk"]
    with torch.no_grad():
        g_port = make_chunked_encode(port.eval(), chunk)(batch["context"])["gaussians"]
        _same_gaussians(g_port, ref.encode(batch["context"], chunk))
