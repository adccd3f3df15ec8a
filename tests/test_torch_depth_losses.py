"""The auxiliary depth losses, PyTorch port vs the JAX package, on the CPU.

Each loss of ``training/depth_losses.py`` and ``losses.depth_supervision``
is held against its JAX counterpart on the same numpy-seeded inputs: the
value, and the gradient against ``jax.grad`` of the jitted JAX function.
The ground truth carries NaN holes (``ms_gradient_loss``, the normals) or
zero holes (``depth_supervision``), which must reach neither the value nor
the gradient.  Tolerances: values within rtol 1e-5, gradients within rtol
1e-4 and atol 1e-6 (float32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesplat_tpu.training import depth_losses as jdl
from freesplat_tpu.training import losses as jlo
from freesplat_tpu_torch.training import depth_losses as tdl
from freesplat_tpu_torch.training import losses as tlo
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)

B, H, W = 2, 16, 20
VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
K_PX = np.array([[18.0, 0, 10.0], [0, 17.0, 8.0], [0, 0, 1]], np.float32)


def _depths(seed, holes=0.0):
    """(pred, gt) depth maps: smooth positive fields, gt with ``holes`` of
    its pixels set to NaN."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    base = 2.0 + xs + 0.5 * ys
    pred = (base + 0.1 * rng.standard_normal((B, H, W))).astype(np.float32)
    gt = (base + 0.1 * rng.standard_normal((B, H, W))).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < holes] = np.nan
    return pred, gt


def _check(jfn, tfn, args, wrt):
    """Value and gradients (w.r.t. the argument indices ``wrt``) of the
    jitted ``jfn`` and of ``tfn`` on the same numpy ``args``."""
    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=wrt))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(np.array(a)) for a in args]
    for i in wrt:
        targs[i].requires_grad_(True)
    tval = tfn(*targs)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=VALUE_RTOL)
    for i, jg in zip(wrt, jgrads):
        tg = targs[i].grad.numpy()
        assert np.isfinite(tg).all() and np.isfinite(np.asarray(jg)).all(), i
        np.testing.assert_allclose(tg, np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient of argument {i}")
    return float(tval.detach())


def test_pyramid_and_sobel_match():
    """The blur pool (reflect pad, stride 2) and the normalized Sobel
    (zero-padded SAME), not flipped: within 1e-6."""
    pred, _ = _depths(0)
    jp = jdl.pyrdown(jnp.asarray(pred), 4)
    tp = tdl.pyrdown(torch.from_numpy(pred), 4)
    assert [t.shape for t in tp] == [(B, H, W), (B, 8, 10), (B, 4, 5), (B, 2, 3)]
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tdl._spatial_gradient(t).numpy(),
                                   np.asarray(jdl._spatial_gradient(j)), rtol=1e-6, atol=1e-6)


def test_ms_gradient_loss_with_nan_holes():
    pred, gt = _depths(1, holes=0.05)
    assert np.isnan(gt).any()
    value = _check(lambda p, g: jdl.ms_gradient_loss(g, p),
                   lambda p, g: tdl.ms_gradient_loss(g, p), (pred, gt), wrt=(0,))
    assert value > 0


@pytest.mark.parametrize("masked", [True, False])
def test_scale_invariant_loss(masked):
    pred, gt = _depths(2)
    mask = np.random.default_rng(3).uniform(size=gt.shape) > 0.2
    if masked:
        _check(lambda a, b, m: jdl.scale_invariant_loss(a, b, mask=m),
               lambda a, b, m: tdl.scale_invariant_loss(a, b, mask=m),
               (np.log(gt), np.log(pred), mask), wrt=(1,))
    else:
        _check(jdl.scale_invariant_loss, tdl.scale_invariant_loss,
               (np.log(gt), np.log(pred)), wrt=(1,))


def test_normals_loss_with_nan_holes():
    pred, gt = _depths(4, holes=0.05)
    np.testing.assert_allclose(
        tdl.depth_to_normals(torch.from_numpy(pred), torch.from_numpy(K_PX)).numpy(),
        np.asarray(jdl.depth_to_normals(jnp.asarray(pred), jnp.asarray(K_PX))),
        rtol=1e-5, atol=1e-6)

    def loss(dl):
        return lambda p, g, k: dl.normals_loss(dl.depth_to_normals(g, k),
                                               dl.depth_to_normals(p, k))

    _check(loss(jdl), loss(tdl), (pred, gt, K_PX), wrt=(0,))


def _pair_extrinsics(b):
    """(cur, src) c2w poses: the source camera 5 cm to the side, turned by
    2 degrees, so most projected points land inside the source view."""
    a = np.deg2rad(2.0)
    src = np.eye(4, dtype=np.float32)
    src[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    src[:3, 3] = [0.05, 0.01, 0.0]
    return np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)), np.tile(src, (b, 1, 1))


def test_mv_depth_loss():
    cur, src = _depths(5)
    cur_e, src_e = _pair_extrinsics(B)
    value = _check(jdl.mv_depth_loss, tdl.mv_depth_loss, (cur, src, cur_e, src_e, K_PX),
                   wrt=(0, 1))
    assert value > 0


def test_depth_supervision_matches_total_loss():
    """All four weights through ``total_loss``: MSE plus the four depth
    parts, with zero holes in the sensor depth, 2 context views (so the
    multi-view term runs), against JAX's ``total_loss``; gradients w.r.t.
    the rendered color, the rendered depth and the encoder's depths."""
    rng = np.random.default_rng(6)
    v = 3
    color = rng.uniform(size=(1, v, H, W, 3)).astype(np.float32)
    image = rng.uniform(size=color.shape).astype(np.float32)
    rendered, gt = (np.stack(x)[None] for x in zip(*[_depths(10 + i) for i in range(v)]))
    rendered, gt = rendered[:, :, 0], gt[:, :, 0]
    gt[rng.uniform(size=gt.shape) < 0.1] = 0.0
    enc = np.stack(_depths(7))[None, :, 0]  # (1, 2, h, w)
    intr = np.tile(K_PX / np.array([[W], [H], [1]], np.float32), (1, v, 1, 1))
    ctx_e = np.stack(_pair_extrinsics(1))[None, :, 0]
    ctx_i = intr[:, :2]
    weights = dict(ms_gradient_weight=0.3, scale_invariant_weight=0.2, normals_weight=0.5,
                   mv_consistency_weight=0.7)
    jcfg = jlo.LossCfg(lpips=None, depth=jlo.LossDepthCfg(**weights))
    tcfg = tlo.LossCfg(lpips=None, depth=tlo.LossDepthCfg(**weights))
    names = ("rendered_depth", "gt_depth", "intrinsics", "enc_depth", "ctx_extrinsics",
             "ctx_intrinsics")
    fixed = (gt, intr, ctx_e, ctx_i)

    def jfn(c, r, e):
        ctx = dict(zip(names, (r, fixed[0], fixed[1], e, fixed[2], fixed[3])))
        return jlo.total_loss(jcfg, c, jnp.asarray(image), jnp.asarray(0), depth_ctx=ctx)

    (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(color), jnp.asarray(rendered), jnp.asarray(enc))
    tc, tr, te = (torch.from_numpy(x).requires_grad_(True) for x in (color, rendered, enc))
    tctx = dict(zip(names, (tr, *map(torch.from_numpy, (gt, intr)), te,
                            *map(torch.from_numpy, (ctx_e, ctx_i)))))
    ttotal, tparts = tlo.total_loss(tcfg, tc, torch.from_numpy(image), 0, depth_ctx=tctx)
    ttotal.backward()
    assert set(tparts) == set(jparts) == {"mse", "depth_grad", "depth_si", "depth_normals",
                                          "depth_mv"}
    for k in jparts:
        assert tparts[k].item() != 0.0, k
        np.testing.assert_allclose(tparts[k].item(), float(jparts[k]), rtol=VALUE_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(ttotal.item(), float(jtotal), rtol=VALUE_RTOL)
    for name, t, j in zip(("color", "rendered depth", "encoder depth"), (tc, tr, te), jgrads):
        assert np.isfinite(t.grad.numpy()).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)

    # A zero weight builds no part; no sensor depth leaves only the
    # multi-view term.
    off = tlo.depth_supervision(tlo.LossDepthCfg(), **tctx)
    assert off == {}
    no_gt = tlo.depth_supervision(tcfg.depth, **{**tctx, "gt_depth": None})
    assert set(no_gt) == {"depth_mv"}
