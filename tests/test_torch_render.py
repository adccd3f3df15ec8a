"""Parity: the PyTorch port's render path vs the JAX package, on the CPU.

The same numpy inputs (seeded) go through the JAX function and its port;
the JAX rasterizer runs its Pallas kernel in interpret mode, the port its
plain compositor (the CUDA kernel's CPU stand-in).  Tolerances are those
of ``tests/test_rasterizer_pallas.py`` (Pallas vs the dense reference).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesplat_tpu.geometry import projection as jproj
from freesplat_tpu.models import decoder as jdec
from freesplat_tpu.models.types import Gaussians as JGaussians
from freesplat_tpu.ops import gaussians as jgauss
from freesplat_tpu.ops import mathutil as jmath
from freesplat_tpu.ops import rasterizer as jras
from freesplat_tpu.ops import rasterizer_ref as jref
from freesplat_tpu.ops import rendering as jrend
from freesplat_tpu.ops import sh as jsh
from freesplat_tpu_torch.geometry import projection as tproj
from freesplat_tpu_torch.models import decoder as tdec
from freesplat_tpu_torch.models.types import Gaussians as TGaussians
from freesplat_tpu_torch.ops import gaussians as tgauss
from freesplat_tpu_torch.ops import mathutil as tmath
from freesplat_tpu_torch.ops import rasterizer as tras
from freesplat_tpu_torch.ops import rasterizer_ref as tref
from freesplat_tpu_torch.ops import rendering as trend
from freesplat_tpu_torch.ops import sh as tsh

H, W = 64, 96  # 4 x 6 tiles
INTR = np.array([[1.1, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def make_scene(n=150, seed=0, z_range=(1.0, 8.0), spread=2.0, sh_d=4):
    """Numpy scene as in tests/test_rasterizer_pallas.py (covariances from
    the JAX build_covariance, so both sides read identical inputs)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(
        [-spread, -spread, z_range[0]], [spread, spread, z_range[1]], size=(n, 3)
    ).astype(np.float32)
    scales = rng.uniform(0.03, 0.35, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4))
    quats = (quats / np.linalg.norm(quats, axis=-1, keepdims=True)).astype(np.float32)
    cov = np.asarray(jgauss.build_covariance(scales, quats))
    harm = (rng.normal(size=(n, 3, sh_d)) * 0.4).astype(np.float32)
    opac = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    extr = np.eye(4, dtype=np.float32)
    return means, cov, harm, opac, extr, INTR.copy()


def _jit(fn, **static):
    """JAX side jitted (eager Pallas interpret mode is ~6x slower)."""
    return jax.jit(functools.partial(fn, **static))


def _both(args, shape, bg, sh_degree, **kw):
    j = _jit(jras.rasterize, image_shape=shape, sh_degree=sh_degree,
             return_stats=True, **kw)(*[jnp.asarray(a) for a in args],
                                      background=jnp.asarray(bg))
    with torch.no_grad():
        t = tras.rasterize(*[_t(a) for a in args], shape, _t(bg), sh_degree,
                           return_stats=True, **kw)
    return j, t


def _close(j, t, atol_c, atol_d, what="", rtol_d=0.0):
    for name, a, b, tol, rtol in zip(
        ("color", "depth", "alpha"), j[:3], t[:3], (atol_c, atol_d, atol_c),
        (0.0, rtol_d, 0.0),
    ):
        np.testing.assert_allclose(
            b.numpy(), np.asarray(a), atol=tol, rtol=rtol, err_msg=f"{what} {name}"
        )
    assert int(j[3]["dropped"]) == int(t[3]["dropped"]), what
    assert int(j[3]["num_instances"]) == int(t[3]["num_instances"]), what


def test_primitives_match():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tproj.homogenize_points(_t(pts)).numpy(), np.asarray(jproj.homogenize_points(pts))
    )
    intr = np.stack([INTR, np.array([[0.9, 0, 0.45], [0, 1.3, 0.52], [0, 0, 1]], np.float32)])
    np.testing.assert_allclose(  # fp32 inverse + arccos: a few ulp
        tproj.get_fov(_t(intr)).numpy(), np.asarray(jproj.get_fov(intr)), atol=1e-6
    )
    v = np.concatenate([pts.reshape(-1, 3), np.zeros((1, 3), np.float32)])
    np.testing.assert_allclose(
        tmath.safe_normalize(_t(v)).numpy(), np.asarray(jmath.safe_normalize(v)), atol=1e-7
    )
    dirs = np.asarray(jmath.safe_normalize(pts.reshape(-1, 3)))
    for deg in range(4):
        d_sh = (deg + 1) ** 2
        sh = rng.normal(size=(dirs.shape[0], 3, d_sh)).astype(np.float32)
        np.testing.assert_allclose(
            tsh.eval_sh_basis(_t(dirs), deg).numpy(),
            np.asarray(jsh.eval_sh_basis(dirs, deg)), atol=1e-6,
        )
        np.testing.assert_allclose(
            tsh.eval_sh(_t(sh), _t(dirs), deg).numpy(),
            np.asarray(jsh.eval_sh(sh, dirs, deg)), atol=1e-5,
        )
    q = rng.normal(size=(50, 4)).astype(np.float32)
    s = rng.uniform(0.01, 2.0, size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgauss.quaternion_to_matrix(_t(q)).numpy(),
        np.asarray(jgauss.quaternion_to_matrix(q)), atol=1e-6,
    )
    np.testing.assert_allclose(  # plain matmul vs the elementwise matmul3
        tgauss.build_covariance(_t(s), _t(q)).numpy(),
        np.asarray(jgauss.build_covariance(s, q)), rtol=1e-5, atol=1e-6,
    )
    near = np.array([0.5, 1.0], np.float32)
    fov = np.array([1.0, 0.7], np.float32)
    np.testing.assert_allclose(
        trend.get_projection_matrix(_t(near), _t(near * 100), _t(fov), _t(fov * 0.9)).numpy(),
        np.asarray(jrend.get_projection_matrix(near, near * 100, fov, fov * 0.9)),
        rtol=1e-6,
    )


def test_preprocess_fields_match():
    means, cov, harm, opac, extr, intr = make_scene(n=300, seed=7, z_range=(0.1, 9.0))
    extr = extr.copy()
    extr[:3, 3] = [0.1, -0.2, 0.3]
    js = _jit(jrend.preprocess_gaussians, image_shape=(H, W), sh_degree=1)(
        *[jnp.asarray(a) for a in (means, cov, harm, opac, extr, intr)]
    )
    ts = trend.preprocess_gaussians(
        *[_t(a) for a in (means, cov, harm, opac, extr, intr)], (H, W), 1
    )
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    m = np.asarray(js.mask)
    assert 0 < m.sum() < len(m)  # some culled by the near plane
    # Pixel means ~1e2 px: float32 relative rounding of the projection.
    np.testing.assert_allclose(ts.means2d.numpy()[m], np.asarray(js.means2d)[m],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.conics.numpy()[m], np.asarray(js.conics)[m],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ts.colors.numpy(), np.asarray(js.colors), atol=1e-5)
    np.testing.assert_allclose(ts.depths.numpy(), np.asarray(js.depths), atol=1e-6)
    np.testing.assert_array_equal(ts.radii.numpy(), np.asarray(js.radii))
    assert np.isfinite(ts.conics.numpy()).all()  # the z_safe guard


def test_render_reference_matches():
    means, cov, harm, opac, extr, intr = make_scene(n=120, seed=3)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    j = _jit(jref.render_reference, image_shape=(H, W), sh_degree=1)(
        *[jnp.asarray(a) for a in (means, cov, harm, opac, extr, intr)],
        background=jnp.asarray(bg),
    )
    t = tref.render_reference(*[_t(a) for a in (means, cov, harm, opac, extr, intr)],
                              (H, W), _t(bg), 1)
    for a, b, tol in zip(j, t, (2e-5, 2e-4, 2e-5)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol)


def test_bin_gaussians_matches():
    means, cov, harm, opac, extr, intr = make_scene(n=200, seed=1)
    cap = 16 * 200
    js = _jit(jrend.preprocess_gaussians, image_shape=(H, W), sh_degree=1)(
        *[jnp.asarray(a) for a in (means, cov, harm, opac, extr, intr)]
    )
    jb = _jit(jras.bin_gaussians, image_shape=(H, W), capacity=cap)(js)
    # Identical screen inputs on both sides: binning decisions are exact.
    ts = trend.Screen(*[_t(np.asarray(f)) for f in js])
    tb = tras.bin_gaussians(ts, (H, W), cap)
    assert int(tb.num_instances) == int(jb.num_instances)
    assert int(tb.dropped) == int(jb.dropped)
    np.testing.assert_array_equal(tb.tile_count.numpy(), np.asarray(jb.tile_count))
    j_ids = np.asarray(jb.sorted_ids)
    t_ids = tb.sorted_ids.numpy()
    for t in range(tb.tile_count.shape[0]):
        c = int(tb.tile_count[t])
        js0, ts0 = int(jb.tile_start[t]), int(tb.tile_start[t])
        np.testing.assert_array_equal(t_ids[ts0:ts0 + c], j_ids[js0:js0 + c])
    # The prune removed some bbox instances.
    assert int(tb.tile_count.sum()) < int(tb.num_instances)


CASES = {
    # name: (scene kwargs, render kwargs, opacity override, shape, bg, atol color/alpha, atol depth)
    "random_s0": (dict(seed=0), {}, None, (H, W), (0.1, 0.2, 0.3), 2e-5, 2e-4),
    "random_s1": (dict(seed=1), {}, None, (H, W), (0.1, 0.2, 0.3), 2e-5, 2e-4),
    "fuzz_near_cull": (dict(n=40, seed=11, z_range=(0.21, 0.5), spread=0.5),
                       dict(capacity=64 * 40), None, (H, W), (0.3, 0.1, 0.6), 5e-5, 5e-5),
    "fuzz_depth_ties_wall": (dict(n=60, seed=12, z_range=(1.0, 1.05), spread=3.0),
                             dict(capacity=64 * 60), 0.98, (H, W), (0.3, 0.1, 0.6), 5e-5, 5e-5),
    "fuzz_tiny": (dict(n=5, seed=13, z_range=(2.0, 3.0), spread=0.1),
                  dict(capacity=64 * 5), None, (H, W), (0.3, 0.1, 0.6), 5e-5, 5e-5),
    "fuzz_huge_range": (dict(n=200, seed=14, z_range=(0.5, 40.0), spread=6.0),
                        dict(capacity=64 * 200), None, (H, W), (0.3, 0.1, 0.6), 5e-5, 5e-5),
    "dense_overlap": (dict(n=300, seed=2, z_range=(2.0, 4.0), spread=0.3),
                      dict(capacity=64 * 300), 0.95, (H, W), (0, 0, 0), 5e-5, 5e-4),
    "capacity_clamp": (dict(n=100, seed=5), dict(capacity=64), None, (H, W), (0, 0, 0),
                       2e-5, 2e-4),
    "overflow_ample": (dict(n=100, seed=5), dict(capacity=16 * 100), None, (H, W),
                       (0, 0, 0), 2e-5, 2e-4),
    "nonsquare_partial_tiles": (dict(n=60, seed=6), {}, None, (50, 70), (0.2, 0.2, 0.2),
                                2e-5, 2e-4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_matches_jax(case):
    scene_kw, kw, op, shape, bg, atol_c, atol_d = CASES[case]
    means, cov, harm, opac, extr, intr = make_scene(sh_d=4, **scene_kw)
    if op is not None:
        opac = np.full_like(opac, op)
    j, t = _both((means, cov, harm, opac, extr, intr), shape,
                 np.asarray(bg, np.float32), 1, **kw)
    # Depth is alpha-weighted view z.  The two packages project pixel means
    # with differently rounded float32 arithmetic (a few ulp of ~60 px);
    # that moves alpha by ~1e-5 relative, and the fuzz scenes reach z = 40,
    # so depth gets a relative term beside its absolute one.
    _close(j, t, atol_c, atol_d, case, rtol_d=1e-5 if case.startswith("fuzz") else 0.0)
    if case == "capacity_clamp":
        # Starved capacity: the shortfall is reported exactly.
        total = int(t[3]["num_instances"])
        assert int(t[3]["dropped"]) == total - 128 > 0
        assert np.isfinite(t[0].numpy()).all()
    if case == "overflow_ample":
        assert int(t[3]["dropped"]) == 0 and int(t[3]["num_instances"]) > 0


def test_rasterize_ellipse_with_anisotropic_needles():
    rng = np.random.default_rng(21)
    n = 50
    means = rng.uniform([-2, -2, 2.0], [2, 2, 6.0], size=(n, 3)).astype(np.float32)
    scales = np.full((n, 3), 0.005, np.float32)
    scales[:, 0] = 0.5  # 100:1 needles
    quats = rng.normal(size=(n, 4))
    quats = (quats / np.linalg.norm(quats, axis=-1, keepdims=True)).astype(np.float32)
    cov = np.asarray(jgauss.build_covariance(scales, quats))
    harm = (rng.normal(size=(n, 3, 4)) * 0.4).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, size=n).astype(np.float32)
    j, t = _both((means, cov, harm, opac, np.eye(4, dtype=np.float32), INTR), (H, W),
                 np.zeros(3, np.float32), 1, capacity=64 * n)
    _close(j, t, 5e-5, 5e-5, "anisotropic", rtol_d=1e-5)  # as the fuzz cases


def test_empty_and_culled_tiles_give_background():
    means, cov, harm, opac, extr, intr = make_scene(n=20, seed=4)
    means = means - np.array([0.0, 0.0, 30.0], np.float32)  # all behind camera
    bg = np.array([0.5, 0.6, 0.7], np.float32)
    j, t = _both((means, cov, harm, opac, extr, intr), (H, W), bg, 1)
    _close(j, t, 1e-6, 1e-6, "culled")
    np.testing.assert_allclose(t[0].numpy(), np.broadcast_to(bg, (H, W, 3)), atol=1e-6)
    assert int(t[3]["num_instances"]) == 0


def test_render_capacity_pins_jax_formula():
    """One helper for the budget; equal to the JAX decoder's inline formula
    ``max(int(f * n), 32768)`` after rasterize()'s round-up to 128, read
    back through the JAX ``aligned_capacity`` (which rounds the same way)."""
    for n in (0, 1, 1000, 10923, 393_216, 5_900_000):
        for f in (0.5, 1.0, 2.0, 3.0):
            jax_cap = max(int(f * n), 32768)
            jax_rounded = jras.aligned_capacity(jax_cap, (16, 16)) - jras.CHUNK
            assert tras.render_capacity(n, f) == jax_rounded, (n, f)
    # rasterize()'s default equals the JAX default max(3n, 32768).
    assert tras.render_capacity(20_000, 3.0) == 60_032


@pytest.mark.parametrize("mode", ["depth", "ref_compat", "raw"])
def test_render_views_matches_jax(mode):
    rng = np.random.default_rng(30)
    b, v, g = 2, 2, 120
    means = rng.uniform([-2, -2, 2.0], [2, 2, 6.0], size=(b, g, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, size=(b, g, 3)).astype(np.float32)
    quats = rng.normal(size=(b, g, 4)).astype(np.float32)
    cov = np.asarray(jgauss.build_covariance(scales, quats))
    harm = (rng.normal(size=(b, g, 3, 9)) * 0.3).astype(np.float32)
    opac = rng.uniform(0.2, 1.0, size=(b, g)).astype(np.float32)
    mask = rng.uniform(size=(b, g)) > 0.2
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    extr[:, 1, :3, 3] = [0.2, -0.1, 0.1]
    intr = np.tile(INTR, (b, v, 1, 1))
    near = np.full((b, v), 0.5, np.float32)
    far = np.full((b, v), 15.0, np.float32)
    cfg_kw = dict(scale_invariant=True, sh_degree=2, depth_mode=mode,
                  background_color=(0.1, 0.0, 0.2))
    jo = _jit(jdec.render_views, cfg=jdec.DecoderCfg(**cfg_kw), image_shape=(32, 48))(
        gaussians=JGaussians(*[jnp.asarray(x) for x in (means, cov, harm, opac, mask)]),
        extrinsics=jnp.asarray(extr), intrinsics=jnp.asarray(intr),
        near=jnp.asarray(near), far=jnp.asarray(far),
    )
    with torch.no_grad():
        to = tdec.render_views(
            tdec.DecoderCfg(**cfg_kw),
            TGaussians(*[_t(x) for x in (means, cov, harm, opac, mask)]),
            _t(extr), _t(intr), _t(near), _t(far), (32, 48),
        )
    np.testing.assert_allclose(to.color.numpy(), np.asarray(jo.color), atol=2e-5)
    np.testing.assert_allclose(to.alpha.numpy(), np.asarray(jo.alpha), atol=2e-5)
    # 'depth' divides by alpha: where alpha ~ 1/255 the quotient amplifies
    # the 2e-4 accumulated-depth tolerance, so compare relative there.
    np.testing.assert_allclose(to.depth.numpy(), np.asarray(jo.depth), atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(to.dropped.numpy(), np.asarray(jo.dropped))
    assert to.color.shape == (b, v, 32, 48, 3)
