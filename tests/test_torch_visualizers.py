"""Validation's panels and projections in the PyTorch port vs the JAX package,
on the CPU.

``utils/drawing.py``, ``utils/encoder_visualizer.py``,
``utils/epipolar_viz.py``, ``utils/camera_viz.py``,
and ``models/render_extras.py`` take the same numpy inputs in both
packages (``validation_step(save_projections=True)`` as a whole is held
against JAX's in ``tests/test_torch_cli.py``).  Drawn panels are compared
as the uint8 images validation writes (equal), and as floats within 1e-6
(the signed distances round differently by an ulp); the epipolar panel
draws at sample coordinates that the two packages' float32 geometry puts
up to ~1e-7 apart, so its floats agree within 1e-5 and its bytes within 1
on at most 0.01 % of the values.  Renders: the JAX side runs its dense
reference compositor (``use_pallas=False``); the port runs its default tile
path (the forward kernel's plain version on the CPU) and its own dense
reference, held to ``tests/test_torch_render.py``'s fuzz tolerances
(color 5e-5).  The JAX epipolar sampler and its Pallas rasterizer run
jitted (``jit_jax_panels``): eagerly they take ~18 s a call here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from freesplat_tpu.models import render_extras as jre
from freesplat_tpu.models.epipolar_sampler import EpipolarSampler as JSampler
from freesplat_tpu.models.types import Gaussians as JGaussians
from freesplat_tpu.ops import rasterizer as jras
from freesplat_tpu.ops.gaussians import build_covariance
from freesplat_tpu.utils import camera_viz as jcv
from freesplat_tpu.utils import drawing as jdraw
from freesplat_tpu.utils import encoder_visualizer as jviz
from freesplat_tpu.utils import epipolar_viz as jepv
from freesplat_tpu.utils.visualization import apply_color_map as jax_color_map
from freesplat_tpu_torch.models import render_extras as tre
from freesplat_tpu_torch.models.epipolar_sampler import EpipolarSampler as TSampler
from freesplat_tpu_torch.models.types import Gaussians as TGaussians
from freesplat_tpu_torch.utils import camera_viz as tcv
from freesplat_tpu_torch.utils import drawing as tdraw
from freesplat_tpu_torch.utils import encoder_visualizer as tviz
from freesplat_tpu_torch.utils import epipolar_viz as tepv
from freesplat_tpu_torch.utils.visualization import apply_color_map
from tests.test_torch_slice import make_scene

COLOR_ATOL = 5e-5  # tests/test_torch_render.py's fuzz cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit_jax_panels(monkeypatch):
    """Run the JAX package's epipolar sampler and its Pallas rasterizer (in
    interpret mode on the CPU) under ``jax.jit`` where its panels call them
    eagerly."""
    call = JSampler.__call__
    monkeypatch.setattr(JSampler, "__call__",
                        lambda self, *a: jax.jit(functools.partial(call, self))(*a))

    @functools.lru_cache(maxsize=None)
    def jitted(image_shape, sh_degree):
        return jax.jit(functools.partial(jras.rasterize, image_shape=image_shape,
                                         sh_degree=sh_degree))

    def rasterize(means, cov, harm, opac, extr, intr, image_shape, background, sh_degree):
        return jitted(tuple(image_shape), sh_degree)(means, cov, harm, opac, extr, intr,
                                                     background=background)

    monkeypatch.setattr(jre, "rasterize", rasterize)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _uint8(x):
    return (np.clip(_np(x), 0, 1) * 255).astype(np.uint8)


def assert_same_panel(t, j, atol=1e-6, off_by_one=0.0):
    """Floats within ``atol``; bytes equal, or within 1 on at most the
    ``off_by_one`` share of the values."""
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=atol, rtol=0)
    d = np.abs(_uint8(t).astype(int) - _uint8(j).astype(int))
    assert d.max() <= (1 if off_by_one else 0) and (d > 0).mean() <= off_by_one


def posed_views(v, seed, h=48, w=64, spread=0.3):
    rng = np.random.default_rng(seed)
    extr = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    for i in range(v):
        a = 0.1 * i
        extr[0, i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        extr[0, i, :3, 3] = [spread * i, 0.03 * rng.standard_normal(), 0.05 * i]
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.3, 0.5], [0, 0, 1]], np.float32), (1, v, 1, 1))
    return {
        "image": rng.uniform(size=(1, v, h, w, 3)).astype(np.float32),
        "extrinsics": extr,
        "intrinsics": intr,
        "near": np.full((1, v), 0.5, np.float32),
        "far": np.full((1, v), 15.0, np.float32),
    }


@pytest.mark.parametrize("what", ["points", "round", "butt", "square", "cameras"])
def test_drawing_matches_jax(what):
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(40, 56, 3)).astype(np.float32)
    cols = rng.uniform(size=(9, 3)).astype(np.float32)
    if what == "points":
        pts = rng.uniform(size=(9, 2)).astype(np.float32)
        kw = dict(radius=3, inner_radius=1, x_range=(0, 1), y_range=(0, 1))
        t, j = tdraw.draw_points(img, pts, cols, **kw), jdraw.draw_points(img, pts, cols, **kw)
    elif what == "cameras":
        extr = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        extr[:, :3, 3] = rng.normal(size=(3, 3))
        intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (3, 1, 1))
        kw = dict(near=np.full(3, 0.5, np.float32), far=np.full(3, 2.0, np.float32))
        t = tdraw.draw_cameras(48, extr, intr, cols[:3], **kw)
        j = jdraw.draw_cameras(48, extr, intr, cols[:3], **kw)
        assert t.shape == (3, 48, 48, 3)
    else:
        s, e = (rng.uniform(size=(7, 2)).astype(np.float32) * 50 for _ in range(2))
        s[0] = e[0]  # a zero-length segment
        t = tdraw.draw_lines(img, s, e, cols[:7], width=3, cap=what)
        j = jdraw.draw_lines(img, s, e, cols[:7], width=3, cap=what)
    assert_same_panel(t, j)
    assert np.abs(_np(t) - (img if what != "cameras" else 0)).max() > 0.1  # something drawn


def test_inferno_table_matches_matplotlib():
    x = np.random.default_rng(1).uniform(-0.1, 1.1, size=(33, 47)).astype(np.float32)
    x[0, :3] = (0.0, 1.0, 0.5)
    assert np.array_equal(apply_color_map(x, "inferno"), jax_color_map(x, "inferno"))


def test_visualize_depth_and_gaussians_match_jax():
    rng = np.random.default_rng(2)
    v, h, w = 2, 16, 24
    ctx = {"near": np.full((1, v), 0.5, np.float32), "far": np.full((1, v), 15.0, np.float32)}
    depth = rng.uniform(0.3, 17.0, size=(1, v, h, w)).astype(np.float32)
    assert_same_panel(tviz.visualize_depth(ctx, _t(depth)), jviz.visualize_depth(ctx, depth))

    g = v * h * w
    imgs = rng.uniform(size=(1, v, h, w, 3)).astype(np.float32)
    op = rng.uniform(size=(1, g)).astype(np.float32)
    a = rng.normal(size=(1, g, 3, 3)).astype(np.float32) * 0.1
    cov = a @ np.swapaxes(a, -1, -2) + 1e-4 * np.eye(3, dtype=np.float32)
    col = rng.uniform(-0.2, 1.2, size=(1, g, 3)).astype(np.float32)
    assert_same_panel(tviz.visualize_gaussians(_t(imgs), _t(op), _t(cov), _t(col)),
                      jviz.visualize_gaussians(imgs, op, cov, col))


@pytest.mark.parametrize("seed", [0, 7])
def test_visualize_epipolar_samples_matches_jax(seed, monkeypatch):
    jit_jax_panels(monkeypatch)
    ctx = posed_views(3, seed=3)
    t = tviz.visualize_epipolar_samples(ctx, seed=seed)
    j = jviz.visualize_epipolar_samples(ctx, seed=seed)
    assert_same_panel(t, j, atol=1e-5, off_by_one=1e-4)
    # The ray view is drawn on: the panel is not the plain images.
    assert t.shape[1] > 2 * 64


def test_visualize_epipolar_sampling_matches_jax(monkeypatch):
    jit_jax_panels(monkeypatch)
    ctx = posed_views(2, seed=4, h=16, w=16)
    args = [ctx[k] for k in ("image", "extrinsics", "intrinsics", "near", "far")]
    j = JSampler(2, 6)(*[jnp.asarray(a) for a in args])
    t = TSampler(2, 6)(*[_t(a) for a in args])
    for view in (0, 1):
        ts = tepv.visualize_epipolar_sampling(ctx["image"][0], t, view=view)
        js = jepv.visualize_epipolar_sampling(ctx["image"][0], j, view=view)
        assert np.array_equal(_uint8(ts), _uint8(js))


def cloud(n=300, seed=5):
    rng = np.random.default_rng(seed)
    means = rng.uniform([-1, -0.7, 2], [1, 0.7, 5], size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.03, 0.15, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    cov = np.asarray(build_covariance(jnp.asarray(scales), jnp.asarray(quats)))
    harm = (rng.normal(size=(n, 3, 1)) * 0.5).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, size=n).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    arrays = (means, cov, harm, opac, mask)
    return (JGaussians(*[jnp.asarray(a) for a in arrays]),
            TGaussians(*[_t(a) for a in arrays]))


@pytest.mark.parametrize("mode", ["orthographic", "projections", "depth", "disparity",
                                  "relative_disparity", "log"])
def test_render_extras_match_jax(mode):
    jg, tg = cloud()
    extr = np.eye(4, dtype=np.float32)
    intr = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)
    outs = []
    for use_reference in (False, True):
        if mode == "orthographic":
            kw = dict(width=3.0, height=2.5, near=0.1, far=20.0, image_shape=(32, 48),
                      sh_degree=0, fov_degrees=5.0)
            j = jre.render_orthographic(jg, jnp.asarray(extr), background=jnp.asarray(
                [0.3, 0.3, 0.3]), use_pallas=False, **kw)
            t = tre.render_orthographic(tg, _t(extr), background=_t([0.3, 0.3, 0.3]),
                                        use_reference=use_reference, **kw)
        elif mode == "projections":
            j = jre.render_projections(jg, resolution=48, use_pallas=False)
            t = tre.render_projections(tg, resolution=48, use_reference=use_reference)
        else:
            args = (jnp.asarray(0.5), jnp.asarray(15.0), (32, 32))
            j = jre.render_depth(jg, jnp.asarray(extr), jnp.asarray(intr), *args, mode=mode,
                                 use_pallas=False)
            t = tre.render_depth(tg, _t(extr), _t(intr), _t(0.5), _t(15.0), (32, 32), mode=mode,
                                 use_reference=use_reference)
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        # Depth modes render z (up to 5) or log z as color: relative.
        np.testing.assert_allclose(t.numpy(), j, atol=COLOR_ATOL, rtol=1e-5 if
                                   mode in ("depth", "log") else 0, err_msg=str(use_reference))
        outs.append(t)
    assert outs[0].std() > 1e-3  # the views see the cloud


def test_camera_viz_matches_jax():
    rng = np.random.default_rng(6)
    b = 4
    extr = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    for i in range(b):
        a = 0.4 * i
        extr[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    extr[:, :3, 3] = rng.normal(size=(b, 3))
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (b, 1, 1))
    depth = rng.uniform(0.5, 2, size=b).astype(np.float32)
    np.testing.assert_allclose(tcv.unproject_frustum_corners(extr, intr, depth),
                               jcv.unproject_frustum_corners(extr, intr, depth), atol=1e-6)
    lo, hi = rng.normal(size=3), rng.normal(size=3) + 2
    for a, c in zip(tcv.compute_equal_aabb_with_margin(lo, hi),
                    jcv.compute_equal_aabb_with_margin(lo, hi)):
        np.testing.assert_array_equal(a, c)
    color = rng.uniform(size=(b, 3)).astype(np.float32)
    near, far = np.full(b, 0.5, np.float32), np.full(b, 3.0, np.float32)
    for kw in (dict(), dict(near=near), dict(near=near, far=far)):
        assert np.array_equal(_uint8(tcv.draw_cameras(64, extr, intr, color, **kw)),
                              _uint8(jcv.draw_cameras(64, extr, intr, color, **kw)))
    batch = make_scene(6, v_ctx=2, v_tgt=3, h=32, w=32)
    t = tcv.render_cameras({k: {f: _t(a) for f, a in batch[k].items()}
                            for k in ("context", "target")}, resolution=64)
    assert np.array_equal(_uint8(t), _uint8(jcv.render_cameras(batch, resolution=64)))
