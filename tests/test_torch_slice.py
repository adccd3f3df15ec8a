"""The whole serving slice, JAX vs the PyTorch port, on the CPU.

2 context views at 64x64, D=8 depth planes, 2 target views: JAX
``EncoderFreeSplat.apply`` (BN with batch statistics, as at test time)
plus ``render_views``, against the port's encoder plus ``render_views``
under the same weights (filled from a seed, bridged).  Then the port's
``run_test`` on two numpy-made scenes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from freesplat_tpu.models import decoder as jdec
from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.models.adapter import GaussianAdapterCfg as JAdapterCfg
from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.evaluation.harness import run_test
from freesplat_tpu_torch.models import decoder as tdec
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models.adapter import GaussianAdapterCfg as TAdapterCfg
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_encoder import _n, _t, fill_variables

H = W = 64
D = 8


def make_scene(seed: int, v_ctx=2, v_tgt=2, h=H, w=W):
    """Numpy views: smooth random images, cameras on a short arc (targets
    between the context cameras), ScanNet-like normalized intrinsics."""
    rng = np.random.default_rng(seed)
    n = v_ctx + v_tgt
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, s in enumerate(np.linspace(0.0, 1.0, n)):
        a = 0.08 * s
        extr[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        extr[i, :3, 3] = [0.3 * s, 0.02 * rng.standard_normal(), 0.05 * s]
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (n, 1, 1))
    coarse = rng.uniform(size=(n, h // 8, w // 8, 3))
    img = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
    img = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1).astype(np.float32)
    order = [0, n - 1] + list(range(1, n - 1))  # context = the two ends
    ctx, tgt = order[:v_ctx], order[v_ctx:]

    def views(idx):
        return {
            "image": img[idx][None],
            "extrinsics": extr[idx][None],
            "intrinsics": intr[idx][None],
            "near": np.full((1, len(idx)), 0.5, np.float32),
            "far": np.full((1, len(idx)), 15.0, np.float32),
        }

    return {"scene": [f"scene{seed}"], "context": views(ctx), "target": views(tgt)}


def test_slice_matches_jax():
    batch = make_scene(0)
    ctx = batch["context"]
    jcfg = jenc.EncoderFreeSplatCfg(num_depth_candidates=D, adapter=JAdapterCfg(sh_degree=2))
    jm = jenc.EncoderFreeSplat(jcfg)
    jctx = {k: jnp.asarray(a) for k, a in ctx.items()}
    shapes = jax.eval_shape(lambda c: jm.init(jax.random.PRNGKey(0), c), jctx)
    var = fill_variables(shapes, seed=1)
    jout, _ = jm.apply(var, jctx, mutable=["batch_stats"])

    tcfg = tenc.EncoderFreeSplatCfg(num_depth_candidates=D, adapter=TAdapterCfg(sh_degree=2))
    tm = load_flax_variables(tenc.EncoderFreeSplat(tcfg), var).eval()  # strict
    with torch.no_grad():
        tout = tm({k: _t(a) for k, a in ctx.items()})

    # Depth maps and densities: the backbone's batch statistics over 2
    # images amplify float32 rounding (see test_torch_encoder), ~1e-4.
    for k in ("depth_s-1", "densities", "depth_weights", "depth_s0", "depth_s3"):
        np.testing.assert_allclose(_n(tout[k]), np.asarray(jout[k]), rtol=1e-3, atol=1e-4,
                                   err_msg=k)

    jg, tg = jout["gaussians"], tout["gaussians"]
    jmask, tmask = np.asarray(jg.mask), _n(tg.mask)
    # PTF rounds pixels and thresholds depths: a 1-ulp input change may flip
    # a slot, so the masks agree on >= 99.9 % of slots, values where both hold.
    assert (jmask == tmask).mean() >= 0.999
    both = jmask & tmask
    assert both.sum() > 0.5 * both.size
    # Relative to each field's scale (covariances ~1e-2, harmonics ~2):
    for f, rtol, atol in (("means", 1e-3, 1e-4), ("covariances", 1e-3, 5e-6),
                          ("harmonics", 1e-3, 1e-4), ("opacities", 1e-3, 1e-4)):
        np.testing.assert_allclose(_n(getattr(tg, f))[both], np.asarray(getattr(jg, f))[both],
                                   rtol=rtol, atol=atol, err_msg=f)

    tgt = batch["target"]
    dcfg = dict(sh_degree=2)
    jr = jdec.render_views(jdec.DecoderCfg(**dcfg), jg,
                           *[jnp.asarray(tgt[k]) for k in ("extrinsics", "intrinsics", "near", "far")],
                           (H, W))
    with torch.no_grad():
        tr = tdec.render_views(tdec.DecoderCfg(**dcfg), tg,
                               *[_t(tgt[k]) for k in ("extrinsics", "intrinsics", "near", "far")],
                               (H, W))
    np.testing.assert_array_equal(_n(tr.dropped), np.asarray(jr.dropped))
    # Images from Gaussian sets that differ by ~1e-4 relative (the BN
    # rounding above): measured max 8e-4 on color, 5e-5 on alpha.
    np.testing.assert_allclose(_n(tr.color), np.asarray(jr.color), atol=2e-3)
    np.testing.assert_allclose(_n(tr.alpha), np.asarray(jr.alpha), atol=2e-4)
    np.testing.assert_allclose(_n(tr.depth), np.asarray(jr.depth), rtol=2e-3, atol=1e-4)


def test_run_test_on_numpy_scenes():
    cfg = load_config([
        "+experiment=scannet/2views", f"encoder.num_depth_candidates={D}",
        "test.save_depth=false", "dataset.image_shape=64,64",
    ])
    timings = {}
    summary = run_test(cfg, batches=iter([make_scene(1), make_scene(2)]),
                       device="cpu", timings=timings)
    assert np.isfinite(summary["psnr"]) and summary["psnr"] > 0
    assert summary["dropped_instances"] == 0
    assert summary["num_gaussians"] > 0
    assert len(timings["encoder_s"]) == 2
