"""Parity: the PyTorch port's encoder modules vs the JAX package, on the CPU.

Each module runs under the same weights on both sides: the JAX parameter
tree is built with ``jax.eval_shape(module.init, ...)`` and filled from a
numpy seed (``init`` itself would compile for minutes), then carried to
the port through ``utils/flax_bridge``.  Inputs are numpy arrays from a
seed.  Tolerances are stated beside each check with their reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from freesplat_tpu.models import adapter as jad
from freesplat_tpu.models import backbone as jbb
from freesplat_tpu.models import cost_volume as jcv
from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.models import layers as jlay
from freesplat_tpu.models import networks as jnet
from freesplat_tpu.models import ptf as jptf
from freesplat_tpu.ops import grid_sample as jgs
from freesplat_tpu_torch.models import adapter as tad
from freesplat_tpu_torch.models import backbone as tbb
from freesplat_tpu_torch.models import cost_volume as tcv
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models import layers as tlay
from freesplat_tpu_torch.models import networks as tnet
from freesplat_tpu_torch.models import ptf as tptf
from freesplat_tpu_torch.ops import grid_sample as tgs
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return x.detach().numpy()


def fill_variables(shapes, seed: int):
    """Numpy values for an ``eval_shape`` tree: lecun-scaled kernels,
    small biases, BN scale ~1 and non-trivial running statistics."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args
    )
    return fill_variables(shapes, seed)


def bridged(torch_module, variables):
    return load_flax_variables(torch_module, variables).eval()


def geometry(v=2, seed=0):
    """Posed views: a small baseline and rotation between cameras."""
    rng = np.random.default_rng(seed)
    extr = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    for i in range(v):
        a = 0.05 * i
        extr[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        extr[i, :3, 3] = [0.15 * i, 0.02 * rng.standard_normal(), 0.01 * i]
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (v, 1, 1))
    return extr, intr


def test_bilinear_sample_matches_packed():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 9, 11, 5)).astype(np.float32)
    coords = rng.uniform([-2, -2], [13, 11], size=(3, 400, 2)).astype(np.float32)
    j = jgs.bilinear_sample_packed(jgs.pack_quad(jnp.asarray(feats)), jnp.asarray(coords))
    t = tgs.bilinear_sample(_t(feats), _t(coords))
    # Same taps, weights and summation order: float32 rounding only.
    np.testing.assert_allclose(_n(t), np.asarray(j), rtol=1e-6, atol=1e-6)
    outside = (coords[..., 0] < -1) | (coords[..., 1] < -1)
    assert np.all(_n(t)[outside] == 0)  # zero padding


@pytest.mark.parametrize("in_ch,feat,stride", [(6, 6, 1), (6, 10, 1), (6, 10, 2)])
def test_basic_block_matches(in_ch, feat, stride):
    x = np.random.default_rng(1).standard_normal((2, 8, 12, in_ch)).astype(np.float32)
    jm = jlay.BasicBlock(feat, stride=stride)
    var = jax_variables(jm, jnp.asarray(x))
    tm = bridged(tlay.BasicBlock(in_ch, feat, stride), var)
    # Two 3x3 convs: float32 sums in another order, ~1e-6 relative.
    np.testing.assert_allclose(_n(tm(_t(x))), np.asarray(jm.apply(var, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_upsample_and_interpolate_match():
    x = np.random.default_rng(2).standard_normal((2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(_n(tlay.upsample2x(_t(x))),
                               np.asarray(jlay.upsample2x(jnp.asarray(x))), atol=1e-6)
    for ac in (True, False):
        np.testing.assert_allclose(
            _n(tlay.interpolate_bilinear(_t(x), (10, 14), align_corners=ac)),
            np.asarray(jlay.interpolate_bilinear(jnp.asarray(x), (10, 14), align_corners=ac)),
            atol=1e-6,
        )


def test_stride2_same_padding_is_asymmetric():
    """flax SAME at stride 2 pads (0, 1); torch padding=1 pads (1, 1)."""
    x = np.random.default_rng(3).standard_normal((1, 8, 8, 3)).astype(np.float32)
    jm = fnn.Conv(4, (3, 3), strides=2, padding="SAME", use_bias=False)
    var = jax_variables(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(var, jnp.asarray(x)))
    tm = bridged(tlay.Conv(3, 4, 3, 2, "SAME", bias=False), var)
    np.testing.assert_allclose(_n(tm(_t(x))), ref, atol=1e-5)
    naive = bridged(tlay.Conv(3, 4, 3, 2, 1, bias=False), var)
    assert np.abs(_n(naive(_t(x))) - ref).max() > 1e-2  # the trap


@pytest.mark.parametrize("train_bn", [True, False])
def test_efficientnet_matches_in_both_bn_regimes(train_bn):
    x = np.random.default_rng(4).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jbb.EfficientNetV2S(train_bn=train_bn)
    var = jax_variables(jm, jnp.asarray(x), seed=4)
    if train_bn:
        jf, _ = jm.apply(var, jnp.asarray(x), mutable=["batch_stats"])
    else:
        jf = jm.apply(var, jnp.asarray(x))
    tm = bridged(tbb.EfficientNetV2S(train_bn=train_bn), var)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        tf = tm(_t(x))
    assert [tuple(f.shape) for f in tf] == [f.shape for f in jf]
    # Per feature (strides 2..32).  Running averages: 40+ layers of float32
    # convs summed in another order.  Batch statistics: at 64x64 the
    # stride-32 BN layers see 2 x 2 x 2 = 8 samples per channel, and
    # normalizing by so few amplifies float32 rounding layer after layer
    # (measured: flax's E[x^2] - E[x]^2 variance in torch errs the same).
    tols = (1e-4, 1e-4, 2e-4, 1e-3, 5e-3) if train_bn else (5e-5,) * 5
    for a, b, tol in zip(tf, jf, tols):
        np.testing.assert_allclose(_n(a), np.asarray(b), atol=tol)
    # Serving never mutates BN state.
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_cost_volume_matches():
    extr, intr = geometry(2)
    mh, mw, c, d = 8, 12, 6, 8
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, mh, mw, c)).astype(np.float32)
    src_idx, src_T_cur, src_K, cur_invK = (
        np.asarray(a) for a in jenc.sweep_geometry(jnp.asarray(extr), jnp.asarray(intr), 2, (mh, mw))
    )
    src = feats[src_idx]  # (2, 1, mh, mw, c)
    jm = jcv.CostVolume(num_depth_bins=d)
    args = (feats, src, src_T_cur, src_K, cur_invK)
    var = jax_variables(jm, *[jnp.asarray(a) for a in args], 0.5, 15.0)
    j = jm.apply(var, *[jnp.asarray(a) for a in args], 0.5, 15.0)
    tm = bridged(tcv.CostVolume(c, num_depth_bins=d), var)
    with torch.no_grad():
        t = tm(*[_t(a) for a in args], torch.full((2,), 0.5), torch.full((2,), 15.0))
    assert t.shape == (2, mh, mw, d)
    np.testing.assert_allclose(_n(t), np.asarray(j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _n(tcv.inverse_depth_planes(d, torch.tensor(0.5), torch.tensor(15.0))),
        np.asarray(jcv.inverse_depth_planes(d, 0.5, 15.0)), rtol=1e-6,
    )
    # The port's torch geometry equals the JAX one.
    tg = tenc.sweep_geometry(_t(extr), _t(intr), 2, (mh, mw))
    for a, b in zip(tg, (src_idx, src_T_cur, src_K, cur_invK)):
        np.testing.assert_allclose(_n(a), b, rtol=1e-6, atol=1e-6)


def test_cv_encoder_and_depth_decoder_match():
    rng = np.random.default_rng(6)
    d = 8
    cv = rng.standard_normal((2, 8, 8, d)).astype(np.float32)
    img = [rng.standard_normal((2, 8 >> i, 8 >> i, ch)).astype(np.float32)
           for i, ch in enumerate((48, 64, 160, 256))]
    jm = jnet.CVEncoder()
    var = jax_variables(jm, jnp.asarray(cv), [jnp.asarray(a) for a in img], seed=6)
    jo = jm.apply(var, jnp.asarray(cv), [jnp.asarray(a) for a in img])
    tm = bridged(tnet.CVEncoder(in_ch=d), var)
    with torch.no_grad():
        to = tm(_t(cv), [_t(a) for a in img])
    for a, b in zip(to, jo):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-4, atol=1e-4)

    dec_in = [rng.standard_normal((2, 16, 16, 24)).astype(np.float32)] + [np.asarray(o) for o in jo]
    jd = jnet.DepthDecoder(num_output_channels=65, num_samples=d)
    var = jax_variables(jd, [jnp.asarray(a) for a in dec_in], seed=7)
    jout = jd.apply(var, [jnp.asarray(a) for a in dec_in])
    td = bridged(tnet.DepthDecoder([24, 64, 128, 256, 384], num_output_channels=65,
                                   num_samples=d), var)
    with torch.no_grad():
        tout = td([_t(a) for a in dec_in])
    assert set(tout) == set(jout)
    for k in jout:
        # ~30 stacked convs and a softmax over planes: ~1e-5 relative.
        np.testing.assert_allclose(_n(tout[k]), np.asarray(jout[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def test_gru_and_positional_encoding_match():
    rng = np.random.default_rng(8)
    pos = rng.uniform(0, 2, size=(7, 2)).astype(np.float32)
    np.testing.assert_allclose(_n(tnet.positional_encoding(_t(pos), 6)),
                               np.asarray(jnet.positional_encoding(jnp.asarray(pos), 6)),
                               atol=1e-6)
    # The interleave: [sin(p0), cos(p0), sin(2 p0), cos(2 p0), ...].
    pe = _n(tnet.positional_encoding(_t(pos), 6))
    np.testing.assert_allclose(pe[:, :4], np.stack(
        [np.sin(pos[:, 0]), np.cos(pos[:, 0]), np.sin(2 * pos[:, 0]), np.cos(2 * pos[:, 0])], -1),
        atol=1e-6)
    c = 16
    args = [rng.standard_normal((30, n)).astype(np.float32) for n in (c, c, 24, 24)]
    jm = jnet.GRU(hidden_channel=c)
    var = jax_variables(jm, *[jnp.asarray(a) for a in args], seed=8)
    tm = bridged(tnet.GRU(hidden_channel=c), var)
    np.testing.assert_allclose(_n(tm(*[_t(a) for a in args])),
                               np.asarray(jm.apply(var, *[jnp.asarray(a) for a in args])),
                               rtol=1e-5, atol=1e-6)


def test_adapter_functions_match():
    rng = np.random.default_rng(9)
    extr, intr = geometry(2)
    depths = rng.uniform(1.0, 4.0, size=(2, 8, 12)).astype(np.float32)
    np.testing.assert_allclose(
        _n(tad.unproject_depth(_t(depths), _t(intr), _t(extr), (8, 12))),
        np.asarray(jad.unproject_depth(jnp.asarray(depths), jnp.asarray(intr),
                                       jnp.asarray(extr), (8, 12))),
        rtol=1e-6, atol=1e-6,
    )
    cfg_j, cfg_t = jad.GaussianAdapterCfg(sh_degree=2), tad.GaussianAdapterCfg(sh_degree=2)
    np.testing.assert_array_equal(_n(tad.sh_mask(cfg_t)), np.asarray(jad.sh_mask(cfg_j)))
    np.testing.assert_allclose(_n(tad.scale_multiplier(_t(intr[0]), (8, 12))),
                               np.asarray(jad.scale_multiplier(jnp.asarray(intr[0]), (8, 12))),
                               rtol=1e-6)
    raw = rng.standard_normal((50, cfg_t.d_in)).astype(np.float32)
    d = rng.uniform(1, 4, 50).astype(np.float32)
    rot = np.tile(extr[1, :3, :3], (50, 1, 1))
    jo = jad.build_gaussians(cfg_j, jnp.asarray(raw), jnp.asarray(d), jnp.asarray(rot),
                             jnp.asarray(intr[0]), (8, 12))
    to = tad.build_gaussians(cfg_t, _t(raw), _t(d), _t(rot), _t(intr[0]), (8, 12))
    for k in ("scales", "rotations", "covariances", "harmonics"):
        # covariance: plain matmuls vs the elementwise matmul3
        np.testing.assert_allclose(_n(to[k]), np.asarray(jo[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def _ptf_inputs(v=3, h=8, w=12, c=8, seed=10, noise=0.3):
    rng = np.random.default_rng(seed)
    extr, intr = geometry(v, seed)
    depth = (2.0 + noise * rng.standard_normal((v, h, w))).astype(np.float32)
    coords = np.array(jad.unproject_depth(jnp.asarray(depth), jnp.asarray(intr),
                                            jnp.asarray(extr), (h, w)))
    return dict(
        feats=rng.standard_normal((v, h * w, c)).astype(np.float32),
        coords=coords.reshape(v, h * w, 3),
        densities=rng.uniform(0.1, 0.9, (v, h * w, 1)).astype(np.float32),
        weights=rng.uniform(0.1, 0.9, (v, h * w, 1)).astype(np.float32),
        depths=depth.reshape(v, h * w),
        extrinsics=extr, intrinsics=intr,
    ), (h, w)


def _fuse_both(inputs, shape, c, seed=11):
    jg = jnet.GRU(hidden_channel=c)
    zf = jnp.zeros((1, c))
    ze = jnp.zeros((1, 24))
    var = jax_variables(jg, zf, zf, ze, ze, seed=seed)
    js = jptf.fuse_views(**{k: jnp.asarray(a) for k, a in inputs.items()},
                         image_shape=shape, gru_apply=lambda *a: jg.apply(var, *a))
    tg = bridged(tnet.GRU(hidden_channel=c), var)
    with torch.no_grad():
        ts = tptf.fuse_views(**{k: _t(a) for k, a in inputs.items()},
                             image_shape=shape, gru_apply=tg)
    return js, ts


def test_fuse_views_matches():
    inputs, shape = _ptf_inputs()
    js, ts = _fuse_both(inputs, shape, 8)
    valid = np.asarray(js.valid)
    np.testing.assert_array_equal(_n(ts.valid), valid)  # discrete decisions equal
    assert 0 < (~valid).sum()  # some pixels merged
    for f in ("feat", "coords", "density", "weight", "depth", "extrinsics"):
        np.testing.assert_allclose(_n(getattr(ts, f))[valid], np.asarray(getattr(js, f))[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_fuse_views_tie_goes_to_largest_slot():
    """Two view-0 slots at the same 3D point tie exactly in view 1's
    z-buffer.  JAX on the CPU lets the last scatter write (the largest
    slot) win; the port's rule is that slot, always."""
    inputs, shape = _ptf_inputs(v=2, seed=12, noise=0.0)  # flat depth 2.0
    hw = shape[0] * shape[1]
    p, q = 40, 41
    # Pull p 3% toward camera 0, so it is the nearest slot at its pixel in
    # view 1 yet still within the 5% depth match; q sits at the same point.
    inputs["coords"][0, p] *= 0.97
    inputs["coords"][0, q] = inputs["coords"][0, p]
    js, ts = _fuse_both(inputs, shape, 8, seed=12)
    # Find view 1's pixel that both slots project to, and check it merged.
    jfeat, tfeat = np.asarray(js.feat), _n(ts.feat)
    assert not np.allclose(jfeat[q], inputs["feats"][0, q]), "tie slot did not merge"
    np.testing.assert_allclose(jfeat[p], inputs["feats"][0, p])  # loser untouched
    np.testing.assert_allclose(tfeat[p], inputs["feats"][0, p])
    np.testing.assert_allclose(tfeat[q], jfeat[q], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_n(ts.valid), np.asarray(js.valid))
    assert hw == inputs["feats"].shape[1]


def test_source_view_selection_matches():
    rng = np.random.default_rng(13)
    v = 6
    extr, _ = geometry(v, 13)
    extr[:, :3, 3] += rng.standard_normal((v, 3)).astype(np.float32)
    np.testing.assert_allclose(_n(tenc.pose_distance_matrix(_t(extr))),
                               np.asarray(jenc.pose_distance_matrix(jnp.asarray(extr))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_n(tenc.select_source_views(_t(extr), 3)),
                                  np.asarray(jenc.select_source_views(jnp.asarray(extr), 3)))


def test_source_view_selection_breaks_ties_like_top_k():
    """A ring of 8 cameras a unit apart around a 2x2 square, all facing
    the same way: every view has tied neighbours (distances 1, sqrt 2, 2,
    sqrt 5, exact in float32 on both sides), and the 5 nearest must come
    out in ``jax.lax.top_k``'s order, the lower index first on a tie."""
    ring = [(0, 0), (1, 0), (2, 0), (2, 1), (2, 2), (1, 2), (0, 2), (0, 1)]
    extr = np.tile(np.eye(4, dtype=np.float32), (len(ring), 1, 1))
    extr[:, :2, 3] = np.asarray(ring, np.float32)
    tdist = _n(tenc.pose_distance_matrix(_t(extr)))
    np.testing.assert_array_equal(tdist, np.asarray(jenc.pose_distance_matrix(jnp.asarray(extr))))
    ties = [len(row) - len(np.unique(row)) for row in tdist]
    assert min(ties) >= 2  # every row has tied distances
    want = np.asarray(jenc.select_source_views(jnp.asarray(extr), 5))
    np.testing.assert_array_equal(_n(tenc.select_source_views(_t(extr), 5)), want)
    # The first view's neighbours: 1 and 7 at 1, 2 and 6 at 2, then 3 at sqrt 5.
    np.testing.assert_array_equal(want[0], [1, 7, 2, 6, 3])
