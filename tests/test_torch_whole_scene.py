"""The whole-scene slice, PyTorch port vs the JAX package, on the CPU.

32x64 images, D = 8 planes, ``num_views=3`` (nearest-2 sources among 6
to 12 context views): the chunked whole-scene encode (``make_chunked_encode``,
2 or 4 views a chunk) in both BN regimes, against JAX's and against the
port's own monolithic encode; the bucketed PTF; the cosine cost volume; the
encoder in bfloat16; ``map_pdf_to_opacity``; and ``run_test`` with
``test.encode_view_chunk``.  Weights are a flax tree filled from a seed
and bridged; tolerances are stated beside each check.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesplat_tpu.config.config import load_config as jax_load_config
from freesplat_tpu.evaluation import harness as jh
from freesplat_tpu.evaluation.harness import run_test as jax_run_test
from freesplat_tpu.models import cost_volume as jcv
from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.models import networks as jnet
from freesplat_tpu.models import ptf as jptf
from freesplat_tpu.models.adapter import GaussianAdapterCfg as JAdapterCfg
from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.evaluation import harness as th
from freesplat_tpu_torch.models import cost_volume as tcv
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models import networks as tnet
from freesplat_tpu_torch.models import ptf as tptf
from freesplat_tpu_torch.models.adapter import GaussianAdapterCfg as TAdapterCfg
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_encoder import (
    _n, _ptf_inputs, _t, bridged, fill_variables, geometry, jax_variables,
)
from tests.test_torch_eval import _tree
from tests.test_torch_slice import make_scene

H, W, D = 32, 64, 8
VIEW_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


def _context(v, seed=0):
    ctx = make_scene(seed, v_ctx=v, v_tgt=1, h=H, w=W)["context"]
    return {k: ctx[k] for k in VIEW_KEYS}


def _encoders(train_bn, seed=1, compute_dtype="float32"):
    """JAX and port encoders (nearest-2 sources) under one seeded weight tree."""
    kw = dict(num_depth_candidates=D, num_views=3, train_bn=train_bn,
              compute_dtype=compute_dtype)
    jm = jenc.EncoderFreeSplat(jenc.EncoderFreeSplatCfg(adapter=JAdapterCfg(sh_degree=2), **kw))
    jctx = {k: jnp.asarray(a) for k, a in _context(6).items()}
    var = fill_variables(jax.eval_shape(lambda c: jm.init(jax.random.PRNGKey(0), c), jctx), seed)
    tm = load_flax_variables(
        tenc.EncoderFreeSplat(tenc.EncoderFreeSplatCfg(adapter=TAdapterCfg(sh_degree=2), **kw)),
        var).eval()
    return jm, var, tm


def _compare_results(tout, jout, flipped=0.0):
    """``tests/test_torch_slice.py::test_slice_matches_jax``'s checks and
    tolerances: depth maps and densities rtol 1e-3 / atol 1e-4; the masks
    on >= 99.9 % of slots; the Gaussians where both masks hold.  With
    ``flipped``, that share of the slots where both masks hold may miss
    the Gaussians' tolerances (PTF merge decisions that flip)."""
    for k in ("depth_s-1", "densities", "depth_weights"):
        np.testing.assert_allclose(_n(tout[k]), np.asarray(jout[k]), rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    jg, tg = jout["gaussians"], tout["gaussians"]
    jmask, tmask = np.asarray(jg.mask), _n(tg.mask)
    assert (jmask == tmask).mean() >= 0.999
    both = jmask & tmask
    assert both.sum() > 0.1 * both.size  # PTF merges most slots of 10 nearby views
    off = np.zeros(int(both.sum()), bool)
    for f, rtol, atol in (("means", 1e-3, 1e-4), ("covariances", 1e-3, 5e-6),
                          ("harmonics", 1e-3, 1e-4), ("opacities", 1e-3, 1e-4)):
        t, j = _n(getattr(tg, f))[both], np.asarray(getattr(jg, f))[both]
        off |= (np.abs(t - j) > atol + rtol * np.abs(j)).reshape(len(off), -1).any(-1)
    assert off.mean() <= flipped, (int(off.sum()), len(off))


@pytest.mark.parametrize("train_bn, chunk, views, flipped",
                         [(False, 2, (6, 10), 0.0), (True, 4, (8, 12), 1e-3)],
                         ids=["running_avg_bn", "batch_stats_bn"])
def test_chunked_encode_matches_jax(train_bn, chunk, views, flipped):
    """(a) ``make_chunked_encode`` at ``chunk`` views a chunk, at 6 or 8
    views (JAX's PTF by ``fuse_views``) and at 10 or 12 (by
    ``fuse_views_bucketed``), in both BN regimes (with batch statistics
    each chunk normalizes with its own), at the slice test's tolerances.

    Batch statistics: each chunk's stride-32 stage normalizes a channel
    over 2 values a view at 32x64, where float32 rounding (flax's
    E[x^2] - E[x]^2 against torch's two-pass variance) is amplified.  With
    4 views a chunk the depth maps hold the slice tolerances (with 2 or 3
    they do not: ROADMAP.md section 3), and PTF's threshold decisions,
    fed depths 1e-6 apart, flip for a few slots (measured: 6 of the
    14,404 slots valid in both at 12 views, 0 at 8), so up to 0.1 % of
    those slots, the masks' own budget, may miss the Gaussians'
    tolerances.  A PTF with twice the depth threshold misses them on 15 %."""
    jm, var, tm = _encoders(train_bn)
    jencode = jh.make_chunked_encode(jm, var, view_chunk=chunk)  # one jit for both v
    timings = {}
    tencode = th.make_chunked_encode(tm, chunk, timings=timings)
    for v in views:
        ctx = _context(v, seed=v)
        jout = jencode({k: jnp.asarray(a) for k, a in ctx.items()})
        with torch.no_grad():
            tout = tencode({k: _t(a) for k, a in ctx.items()})
        _compare_results(tout, jout, flipped)
        assert tout["gaussians"].means.shape == (1, v * H * W, 3)
    assert len(timings["B_trunk_s"]) == sum(-(-v // chunk) for v in views)
    assert len(timings["C2_head_s"]) == 2


def test_chunked_encode_matches_monolithic():
    """(b) The port's chunked encode against its monolithic forward under
    running-average BN: masks equal, values within atol 1e-5 (JAX's own
    test, ``tests/test_main_cli.py``)."""
    _, _, tm = _encoders(train_bn=False, seed=2)
    for v in (6, 10):
        ctx = {k: _t(a) for k, a in _context(v, seed=20 + v).items()}
        with torch.no_grad():
            mono = tm(ctx)
            chunked = th.make_chunked_encode(tm, 2)(ctx)
        g1, g2 = mono["gaussians"], chunked["gaussians"]
        assert torch.equal(g1.mask, g2.mask)
        for f in ("means", "covariances", "harmonics", "opacities"):
            np.testing.assert_allclose(_n(getattr(g2, f))[_n(g2.mask)],
                                       _n(getattr(g1, f))[_n(g1.mask)], atol=1e-5, err_msg=f)
        np.testing.assert_allclose(_n(chunked["depth_s-1"]), _n(mono["depth_s-1"]), atol=1e-5)
    # The stages as the JAX module names them.
    with torch.no_grad():
        match = tm(ctx, stage="match")["match"]
    assert tuple(match.shape) == (1, 10, H // 4, W // 4, 48)
    trunk_only = tenc.EncoderFreeSplat(tenc.EncoderFreeSplatCfg(
        num_depth_candidates=D, num_views=3, train_bn=False, trunk_only=True))
    trunk_only.load_state_dict(tm.state_dict())
    with torch.no_grad():
        trunk = trunk_only.eval()(ctx)
    assert "gaussians" not in trunk and tuple(trunk["feat_v"].shape) == (1, 10, H * W, 64)
    np.testing.assert_allclose(_n(trunk["depth_s-1"]), _n(mono["depth_s-1"]), rtol=0, atol=0)


def test_fuse_views_bucketed_matches():
    """(c) ``fuse_views_bucketed`` against JAX's and against the port's
    ``fuse_views``, with and without a gradient: masks equal, values
    within rtol/atol 1e-5 of JAX and equal to ``fuse_views``."""
    inputs, shape = _ptf_inputs(v=9, seed=14)
    c = inputs["feats"].shape[-1]
    jg = jnet.GRU(hidden_channel=c)
    z = jnp.zeros((1, c))
    var = jax_variables(jg, z, z, jnp.zeros((1, 24)), jnp.zeros((1, 24)), seed=15)
    js = jptf.fuse_views_bucketed(**{k: jnp.asarray(a) for k, a in inputs.items()},
                                  image_shape=shape, gru_apply=lambda *a: jg.apply(var, *a))
    gru = bridged(tnet.GRU(hidden_channel=c), var)
    targs = {k: _t(a) for k, a in inputs.items()}
    with torch.no_grad():
        ts = tptf.fuse_views_bucketed(**targs, image_shape=shape, gru_apply=gru, buckets=(3, 9))
        tf = tptf.fuse_views(**targs, image_shape=shape, gru_apply=gru)
    graded = {k: x.clone().requires_grad_(k != "extrinsics" and k != "intrinsics")
              for k, x in targs.items()}
    tg = tptf.fuse_views_bucketed(**graded, image_shape=shape, gru_apply=gru)
    valid = np.asarray(js.valid)
    assert 0 < (~valid).sum() and valid.sum() > 0
    for other in (ts, tf, tg):
        np.testing.assert_array_equal(_n(other.valid), valid)
    for f in ("feat", "coords", "density", "weight", "depth", "extrinsics"):
        np.testing.assert_allclose(_n(getattr(ts, f))[valid], np.asarray(getattr(js, f))[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
        assert torch.equal(getattr(ts, f), getattr(tf, f)), f
        assert torch.equal(getattr(tg, f).detach(), getattr(tf, f)), f
    tg.feat[_t(valid.astype(np.float32)).bool()].sum().backward()
    assert graded["feats"].grad.abs().sum() > 0


def test_cosine_cost_volume_matches():
    """(d) ``CostVolume(similarity="cosine")`` (no MLP head, no
    parameters) against JAX's, within rtol/atol 1e-5."""
    extr, intr = geometry(3)
    mh, mw, c, d = 8, 12, 6, 8
    feats = np.random.default_rng(16).standard_normal((3, mh, mw, c)).astype(np.float32)
    src_idx, src_T_cur, src_K, cur_invK = (
        np.asarray(a) for a in jenc.sweep_geometry(jnp.asarray(extr), jnp.asarray(intr), 3,
                                                     (mh, mw)))
    args = (feats, feats[src_idx], src_T_cur, src_K, cur_invK)
    jm = jcv.CostVolume(num_depth_bins=d, similarity="cosine")
    j = jm.apply({}, *[jnp.asarray(a) for a in args], 0.5, 15.0)
    tm = tcv.CostVolume(c, num_depth_bins=d, similarity="cosine")
    assert not list(tm.parameters())
    t = tm(*[_t(a) for a in args], torch.full((3,), 0.5), torch.full((3,), 15.0))
    assert t.shape == (3, mh, mw, d) and t.dtype == torch.float32
    np.testing.assert_allclose(_n(t), np.asarray(j), rtol=1e-5, atol=1e-5)
    assert np.abs(_n(t)).max() <= 1.0 + 1e-5  # an average of cosines
    with pytest.raises(ValueError):
        tcv.CostVolume(c, similarity="l2")


def test_bfloat16_encoder_matches_jax():
    """(e) ``compute_dtype="bfloat16"`` against JAX's bfloat16 encoder
    (running-average BN, 3 views): ``depth_s-1`` within 5e-2 relative L2
    of JAX's (measured 4.7e-3), float32 outside the trunk, and bfloat16
    within 5e-2 of the port's own float32 encode (measured 3.7e-3)."""
    jm, var, tm = _encoders(train_bn=False, seed=3, compute_dtype="bfloat16")
    ctx = _context(3, seed=17)
    jout = jax.jit(lambda c: jm.apply(var, c))({k: jnp.asarray(a) for k, a in ctx.items()})
    with torch.no_grad():
        tout = tm({k: _t(a) for k, a in ctx.items()})
        f32 = tenc.EncoderFreeSplat(tenc.EncoderFreeSplatCfg(
            num_depth_candidates=D, num_views=3, train_bn=False,
            adapter=TAdapterCfg(sh_degree=2)))
        f32.load_state_dict(tm.state_dict())
        fout = f32.eval()({k: _t(a) for k, a in ctx.items()})
    assert tm.backbone.stage5_block0.conv_pw.compute_dtype == torch.bfloat16
    assert tm.hr_skip.compute_dtype is None and tm.fuse.to_gaussians.weight.dtype == torch.float32
    for k in ("depth_s-1", "densities", "depth_weights"):
        assert tout[k].dtype == torch.float32 and np.asarray(jout[k]).dtype == np.float32, k
    t, j, f = _n(tout["depth_s-1"]), np.asarray(jout["depth_s-1"]), _n(fout["depth_s-1"])
    rel = np.linalg.norm(t - j) / np.linalg.norm(j)
    assert np.isfinite(t).all() and rel <= 5e-2, rel
    assert np.linalg.norm(t - f) / np.linalg.norm(f) <= 5e-2
    assert tout["gaussians"].means.dtype == torch.float32


def test_map_pdf_to_opacity_matches_jax():
    """(f) At three steps of a warm-up schedule, within rtol 1e-5 (the
    powers round apart by up to 1.9e-6 relative)."""
    pdf = np.random.default_rng(18).uniform(0.0, 1.0, (4, 50)).astype(np.float32)
    jcfg = jenc.OpacityMappingCfg(initial=-1.0, final=2.0, warm_up=10)
    tcfg = tenc.OpacityMappingCfg(initial=-1.0, final=2.0, warm_up=10)
    for step in (0, 5, 20):
        j = np.asarray(jenc.map_pdf_to_opacity(jnp.asarray(pdf), step, jcfg))
        t = _n(tenc.map_pdf_to_opacity(_t(pdf), step, tcfg))
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)  # measured 1.9e-6
    np.testing.assert_allclose(_n(tenc.map_pdf_to_opacity(_t(pdf), 3)), pdf, rtol=1e-5)


def test_run_test_with_encode_view_chunk_matches_jax(tmp_path):
    """(g) ``run_test`` with ``test.encode_view_chunk=2`` on two scenes of
    4 context views (32x32, running-average BN): PSNR within 1e-4 dB of
    JAX's per scene, the same file tree, and the phase timings."""
    overrides = ["dataset.image_shape=[32,32]", "encoder.num_depth_candidates=8",
                 "encoder.num_views=3", "encoder.adapter.sh_degree=1", "decoder.sh_degree=1",
                 "test.bn_batch_stats=false", "test.encode_view_chunk=2", "test.save_depth=false"]
    jcfg = jax_load_config([*overrides, f"test.output_path={tmp_path / 'jax'}"])
    tcfg = load_config([*overrides, f"test.output_path={tmp_path / 'port'}"])
    assert tcfg.test.encode_view_chunk == 2

    def scenes():
        return iter([make_scene(s, v_ctx=4, v_tgt=2, h=32, w=32) for s in (31, 32)])

    ctx = {k: jnp.asarray(a) for k, a in next(scenes())["context"].items()}
    encoder = jenc.EncoderFreeSplat(jcfg.encoder)
    var = fill_variables(jax.eval_shape(lambda c: encoder.init(jax.random.PRNGKey(0), c), ctx),
                         seed=19)
    jax_run_test(jcfg, batches=scenes(), state=var)
    timings = {}
    run_test(tcfg, batches=scenes(), state=var, device="cpu", timings=timings)
    jstats = json.loads((tmp_path / "jax" / "stats.json").read_text())
    tstats = json.loads((tmp_path / "port" / "stats.json").read_text())
    for je, te in zip(jstats["per_scene"], tstats["per_scene"], strict=True):
        assert list(te) == list(je)
        assert abs(te["psnr"] - je["psnr"]) <= 1e-4, (te["psnr"], je["psnr"])
        assert te["num_gaussians"] == je["num_gaussians"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert len(timings["A_match_s"]) == 2 and len(timings["B_trunk_s"]) == 4


run_test = th.run_test
