"""The legacy epipolar stack of the PyTorch port vs the JAX package, on the CPU.

``geometry/projection.py`` (the rest of the module and ``intersect_rays``),
``geometry/pairings.py``, ``geometry/epipolar.py``,
``ops/discrete_distribution.py`` and ``models/epipolar_sampler.py`` take the
same numpy inputs in both packages.  Tolerances: geometry within 1e-5
absolute (float32 matrix inverses and products in another order), index
outputs equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesplat_tpu.geometry import epipolar as jep
from freesplat_tpu.geometry import pairings as jpair
from freesplat_tpu.geometry import projection as jproj
from freesplat_tpu.models.epipolar_sampler import EpipolarSampler as JSampler
from freesplat_tpu.ops import discrete_distribution as jdd
from freesplat_tpu_torch.geometry import epipolar as tep
from freesplat_tpu_torch.geometry import pairings as tpair
from freesplat_tpu_torch.geometry import projection as tproj
from freesplat_tpu_torch.models.epipolar_sampler import EpipolarSampler as TSampler
from freesplat_tpu_torch.ops import discrete_distribution as tdd

GEOMETRY_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def cameras(v, seed=0, spread=0.4):
    """Cameras on a short arc looking roughly the same way: (v, 4, 4) c2w
    and (v, 3, 3) normalized intrinsics."""
    rng = np.random.default_rng(seed)
    extr = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    for i in range(v):
        a = 0.15 * i + 0.02 * rng.standard_normal()
        extr[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        extr[i, :3, 3] = [spread * i, 0.05 * rng.standard_normal(), 0.1 * i]
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.48], [0, 0, 1]], np.float32), (v, 1, 1))
    return extr, intr


def _close(t, j, atol=GEOMETRY_ATOL):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t, np.asarray(j),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["homogenize_vectors", "transform_cam2world",
                                  "transform_world2cam", "project_camera_space", "project",
                                  "unproject", "get_world_rays", "sample_image_grid"])
def test_projection_matches_jax(name):
    rng = np.random.default_rng(1)
    extr, intr = cameras(3, seed=1)
    pts = rng.uniform([-2, -2, 0.5], [2, 2, 6], size=(3, 7, 3)).astype(np.float32)
    xy = rng.uniform(size=(3, 7, 2)).astype(np.float32)
    z = rng.uniform(0.5, 5, size=(3, 7)).astype(np.float32)
    e, k = extr[:, None], intr[:, None]
    if name == "homogenize_vectors":
        outs = (tproj.homogenize_vectors(_t(pts)), jproj.homogenize_vectors(pts))
    elif name == "transform_cam2world":
        h = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
        outs = (tproj.transform_cam2world(_t(h), _t(e)), jproj.transform_cam2world(h, e))
    elif name == "transform_world2cam":
        h = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
        outs = (tproj.transform_world2cam(_t(h), _t(e)), jproj.transform_world2cam(h, e))
    elif name == "project_camera_space":
        cam = pts.copy()
        cam[0, 0, 2] = 0.0  # a point on the camera plane: clamped, not inf
        cam[0, 1, 2] = -1.0
        outs = (tproj.project_camera_space(_t(cam), _t(k)), jproj.project_camera_space(cam, k))
    elif name == "project":
        (t_xy, t_front), (j_xy, j_front) = (tproj.project(_t(pts), _t(e), _t(k)),
                                            jproj.project(pts, e, k))
        assert np.array_equal(t_front.numpy(), np.asarray(j_front))
        outs = (t_xy, j_xy)
    elif name == "unproject":
        outs = (tproj.unproject(_t(xy), _t(z), _t(k)), jproj.unproject(xy, z, k))
    elif name == "get_world_rays":
        (to, td), (jo, jd) = tproj.get_world_rays(_t(xy), _t(e), _t(k)), \
            jproj.get_world_rays(xy, e, k)
        _close(to, jo)
        outs = (td, jd)
    else:
        (tc, ti), (jc, ji) = tproj.sample_image_grid((5, 7)), jproj.sample_image_grid((5, 7))
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert tc.dtype == torch.float32
        outs = (tc, jc)
    assert tuple(outs[0].shape) == np.asarray(outs[1]).shape
    _close(*outs)


def test_intersect_rays_matches_jax():
    rng = np.random.default_rng(2)
    n = 64
    ox = rng.normal(size=(n, 3)).astype(np.float32)
    oy = rng.normal(size=(n, 3)).astype(np.float32)
    dx = rng.normal(size=(n, 3)).astype(np.float32)
    dy = rng.normal(size=(n, 3)).astype(np.float32)
    dx /= np.linalg.norm(dx, axis=-1, keepdims=True)
    dy /= np.linalg.norm(dy, axis=-1, keepdims=True)
    dy[:5] = dx[:5]  # parallel pairs -> the 1e10 stand-in for infinity
    t = tproj.intersect_rays(_t(ox), _t(dx), _t(oy), _t(dy))
    j = np.asarray(jproj.intersect_rays(ox, dx, oy, dy))
    assert (j[:5] == 1e10).all() and (np.abs(j[5:]) < 1e10).all()
    assert np.array_equal(t.numpy() == np.float32(1e10), j == np.float32(1e10))
    # Least-squares solutions of near-degenerate pairs scale float32
    # rounding by the system's conditioning: relative to the point's size.
    fin = j != np.float32(1e10)
    scale = np.maximum(np.abs(j[fin]), 1.0)
    assert (np.abs(t.numpy()[fin] - j[fin]) / scale).max() <= 1e-4
    # Broadcasting one ray against many, as lift_to_3d does.
    t1 = tproj.intersect_rays(_t(ox[0]), _t(dx[0]), _t(oy), _t(dy))
    j1 = np.asarray(jproj.intersect_rays(ox[0], dx[0], oy, dy))
    assert t1.shape == j1.shape


@pytest.mark.parametrize("n", [2, 3, 4, 5, 10])
def test_pairings_match_jax(n):
    for tf, jf in ((tpair.generate_heterogeneous_index, jpair.generate_heterogeneous_index),
                   (tpair.generate_heterogeneous_index_transpose,
                    jpair.generate_heterogeneous_index_transpose)):
        for a, b in zip(tf(n), jf(n)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("bounds", ["near_far", "unbounded"])
def test_project_rays_matches_jax(bounds):
    extr, intr = cameras(3, seed=3)
    xy, _ = jproj.sample_image_grid((12, 16))
    xy = np.asarray(xy).reshape(-1, 2)
    jo, jd = jproj.get_world_rays(xy, extr[0], intr[0])
    jo, jd = np.asarray(jo), np.asarray(jd)
    kw_j, kw_t = {}, {}
    if bounds == "near_far":
        kw_j = dict(near=np.float32(0.5), far=np.float32(8.0))
        kw_t = dict(near=torch.tensor(0.5), far=torch.tensor(8.0))
    for other in (1, 2, 0):  # two others and the casting camera itself
        j = jep.project_rays(jo, jd, extr[other], intr[other], **kw_j)
        t = tep.project_rays(_t(jo), _t(jd), _t(extr[other]), _t(intr[other]), **kw_t)
        valid = np.asarray(j.overlaps_image)
        assert np.array_equal(t.overlaps_image.numpy(), valid), other
        assert valid.any()
        for f in ("xy_min", "xy_max"):
            _close(getattr(t, f).numpy()[valid], np.asarray(getattr(j, f))[valid])
        for f in ("t_min", "t_max"):
            a, b = getattr(t, f).numpy()[valid], np.asarray(getattr(j, f))[valid]
            assert np.array_equal(np.isinf(a), np.isinf(b))
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=GEOMETRY_ATOL)


def test_lift_to_3d_and_get_depth_match_jax():
    extr, intr = cameras(2, seed=4)
    rng = np.random.default_rng(4)
    pts = rng.uniform([-1, -1, 2], [1, 1, 6], size=(20, 3)).astype(np.float32)
    o = np.broadcast_to(extr[0, :3, 3], pts.shape).astype(np.float32)
    d = pts - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xy, _ = jproj.project(pts, extr[1], intr[1])
    xy = np.asarray(xy)
    jl = np.asarray(jep.lift_to_3d(o, d, xy, extr[1], intr[1]))
    tl = tep.lift_to_3d(_t(o), _t(d), _t(xy), _t(extr[1]), _t(intr[1]))
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(jl, pts, atol=1e-3)  # the points come back
    jdep = np.asarray(jep.get_depth(o, d, xy, extr[1], intr[1]))
    tdep = tep.get_depth(_t(o), _t(d), _t(xy), _t(extr[1]), _t(intr[1]))
    np.testing.assert_allclose(tdep.numpy(), jdep, atol=1e-4, rtol=1e-5)


def test_sample_discrete_distribution_matches_jax_at_its_uniforms():
    rng = np.random.default_rng(5)
    pdf = rng.uniform(size=(3, 4, 16)).astype(np.float32)
    pdf[0, 0] = 0.0  # an all-zero row: every sample clamps to the last bucket
    pdf[1, 1, :8] = 0.0
    key = jax.random.PRNGKey(7)
    j_idx, j_dens = jdd.sample_discrete_distribution(jnp.asarray(pdf), key, 12)
    # JAX's own draws, as sample_discrete_distribution makes them.
    u = np.asarray(jax.random.uniform(key, (3, 4, 12), dtype=jnp.float32))
    t_idx, t_dens = tdd.sample_discrete_distribution_at(_t(pdf), _t(u))
    assert t_idx.dtype == torch.int32
    assert np.array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_dens.numpy(), np.asarray(j_dens), atol=1e-7, rtol=1e-6)
    # With a generator: seeded draws repeat, and indices stay in range.
    g = torch.Generator().manual_seed(3)
    a, _ = tdd.sample_discrete_distribution(_t(pdf), g, 12)
    b, _ = tdd.sample_discrete_distribution(_t(pdf), torch.Generator().manual_seed(3), 12)
    assert torch.equal(a, b) and a.shape == (3, 4, 12)
    assert int(a.min()) >= 0 and int(a.max()) <= 15
    assert (a[1, 1] >= 8).all()  # zero-mass buckets are never drawn


def test_gather_discrete_topk_breaks_ties_like_jax():
    rng = np.random.default_rng(6)
    pdf = rng.integers(0, 4, size=(5, 32)).astype(np.float32)  # many exact ties
    pdf[0] = 1.0
    j_idx, j_dens = jdd.gather_discrete_topk(jnp.asarray(pdf), 10)
    t_idx, t_dens = tdd.gather_discrete_topk(_t(pdf), 10)
    assert t_idx.dtype == torch.int32
    assert np.array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(t_dens.numpy(), np.asarray(j_dens))


@pytest.mark.parametrize("v", [2, 3, 4])
def test_epipolar_sampler_matches_jax(v):
    h, w, s = 12, 16, 6
    extr, intr = cameras(v, seed=8, spread=0.25)
    rng = np.random.default_rng(8)
    # Smooth images: a sample's value then moves with its coordinate by
    # about the image's gradient, which stays small.
    coarse = rng.uniform(size=(1, v, 3, 4, 3))
    images = np.repeat(np.repeat(coarse, 4, axis=2), 4, axis=3).astype(np.float32)
    near = np.full((1, v), 0.5, np.float32)
    far = np.full((1, v), 8.0, np.float32)
    j = JSampler(v, s)(jnp.asarray(images), jnp.asarray(extr[None]), jnp.asarray(intr[None]),
                       jnp.asarray(near), jnp.asarray(far))
    tsampler = TSampler(v, s)
    t = tsampler(_t(images), _t(extr[None]), _t(intr[None]), _t(near), _t(far))
    assert np.array_equal(tsampler.index_v.numpy(), np.asarray(JSampler(v, s).index_v))
    valid = np.asarray(j.valid)
    assert np.array_equal(t.valid.numpy(), valid)
    assert valid.mean() > 0.3
    for f in ("xy_ray", "xy_sample", "xy_sample_near", "xy_sample_far", "origins",
              "directions"):
        a = getattr(t, f)
        assert tuple(a.shape) == np.asarray(getattr(j, f)).shape, f
        _close(a, getattr(j, f))
    # Features: bilinear taps of [0, 1] images at coordinates within 1e-5
    # of each other (x w, h pixels): within 1e-4.
    _close(t.features, j.features, atol=1e-4)
