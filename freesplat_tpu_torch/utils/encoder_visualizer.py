"""Encoder visualization panels (reference
``src/model/encoder/visualization/encoder_visualizer_epipolar.py``).

Port of ``freesplat_tpu/utils/encoder_visualizer.py``: ``visualize_depth``
(relative depth and disparity in turbo), ``visualize_gaussians``
(context, opacity, color and covariance-determinant panels of the
per-pixel Gaussians, in view grids) and ``visualize_epipolar_samples``
(a few rays of one view and their epipolar samples in a paired view,
through ``models/epipolar_sampler.py``).  Each returns an (h, w, 3) float
numpy image.  Inputs may be numpy arrays or tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .visualization import (
    add_border, add_label, apply_color_map, as_numpy, get_distinct_color, hcat, vcat,
)


def visualize_depth(context: dict, depth) -> np.ndarray:
    """Relative-depth and relative-disparity turbo panels per view of scene
    0: ``context`` holds near/far (b, v), ``depth`` is (b, v, h, w)."""
    depth = as_numpy(depth)[0]
    near = float(as_numpy(context["near"]).flat[0])
    far = float(as_numpy(context["far"]).flat[0])
    rel_depth = np.clip((depth - near) / (far - near), 0.0, 1.0)
    rel_disp = np.clip(
        1.0 - (1.0 / np.maximum(depth, 1e-6) - 1.0 / far) / (1.0 / near - 1.0 / far), 0.0, 1.0)
    depth_row = hcat(*[apply_color_map(d, "turbo") for d in rel_depth])
    disp_row = hcat(*[apply_color_map(d, "turbo") for d in rel_disp])
    return add_border(hcat(add_label(depth_row, "Depth"), add_label(disp_row, "Disparity")))


def visualize_gaussians(
    context_images,  # (b, v, h, w, 3)
    opacities,  # (b, g) with g = v*h*w (pre-fusion order)
    covariances,  # (b, g, 3, 3)
    colors,  # (b, g, 3) DC colors
) -> np.ndarray:
    """Context / opacity / color / covariance-determinant panels of scene 0
    (reference :243-275), the per-pixel Gaussians back in view grids."""
    imgs = as_numpy(context_images)[0]
    v, h, w, _ = imgs.shape
    op = as_numpy(opacities)[0].reshape(v, h, w)
    col = as_numpy(colors)[0].reshape(v, h, w, 3)
    det = np.linalg.det(as_numpy(covariances)[0].astype(np.float64))
    det = (det / max(det.max(), 1e-30)).reshape(v, h, w)

    def gray(x):
        return np.repeat(np.clip(x, 0.0, 1.0)[..., None], 3, axis=-1)

    return add_border(hcat(
        add_label(vcat(*list(imgs)), "Context"),
        add_label(vcat(*[gray(o) for o in op]), "Opacities"),
        add_label(vcat(*[np.clip(c * o[..., None], 0, 1) for c, o in zip(col, op)]), "Colors"),
        add_label(vcat(*[np.clip(c, 0, 1) for c in col]), "Colors (Raw)"),
        add_label(vcat(*[apply_color_map(d, "inferno") for d in det]), "Determinant"),
    ))


def visualize_epipolar_samples(
    context: dict,
    num_rays: int = 8,
    num_samples: int = 24,
    seed: int = 0,
) -> np.ndarray:
    """Ray-view / sample-view epipolar panel (reference :348-437): a few
    pixels of one view marked in distinct colors; in a paired view their
    epipolar lines in black with the evenly spaced samples on them, in
    alternating black and white buckets.

    The (scene, view, other view, rays) choice comes from
    ``np.random.default_rng(seed)`` in the JAX package's order, so both
    packages pick the same rays.  The sampler and the drawing run on the
    device of ``context["image"]`` (the CPU for numpy)."""
    from ..models.epipolar_sampler import EpipolarSampler
    from .drawing import draw_lines, draw_points

    image = context["image"]
    device = image.device if torch.is_tensor(image) else "cpu"

    def t(x):
        return torch.as_tensor(as_numpy(x), dtype=torch.float32, device=device)

    images = t(context["image"])
    b, v, h, w, _ = images.shape
    sampler = EpipolarSampler(num_views=v, num_samples=num_samples)
    with torch.no_grad():
        sampling = sampler(images, t(context["extrinsics"]), t(context["intrinsics"]),
                           t(context["near"]), t(context["far"]))

    rng = np.random.default_rng(seed)
    rb = int(rng.integers(b))
    rv = int(rng.integers(v))
    ov = sampling.xy_sample.shape[2]
    rov = int(rng.integers(ov))
    r = sampling.xy_ray.shape[2]
    # Prefer rays whose epipolar segment overlaps the other view (the
    # reference draws invalid rays as zero-length stubs).
    pool = np.flatnonzero(as_numpy(sampling.valid[rb, rv, rov]))
    if pool.size == 0:
        pool = np.arange(r)
    rr = rng.choice(pool, size=min(num_rays, pool.size), replace=False)
    colors = [get_distinct_color(i) for i in range(len(rr))]
    sel = torch.as_tensor(rr, device=images.device)

    unit = dict(x_range=(0, 1), y_range=(0, 1))
    rays = sampling.xy_ray[rb, rv, sel]
    ray_view = draw_points(images[rb, rv], rays, (0.0, 0.0, 0.0), radius=4, **unit)
    ray_view = draw_points(ray_view, rays, colors, radius=3, **unit)

    other = int(sampler.index_v[rv, rov])
    near_pts = sampling.xy_sample_near[rb, rv, rov, sel]
    far_pts = sampling.xy_sample_far[rb, rv, rov, sel]
    samples = sampling.xy_sample[rb, rv, rov, sel]
    s = samples.shape[1]

    # The black epipolar line of each ray, then alternating black/white
    # bucket segments, then the colored sample dots (reference :384-433).
    sample_view = draw_lines(images[rb, other], near_pts[:, 0], far_pts[:, -1], (0.0, 0.0, 0.0),
                             width=5, cap="butt", **unit)
    bucket = np.tile([0.0, 1.0], (s + 1) // 2)[:s]
    seg_colors = np.repeat(bucket, 3).reshape(s, 3)[None].repeat(len(rr), axis=0).reshape(-1, 3)
    sample_view = draw_lines(sample_view, near_pts.reshape(-1, 2), far_pts.reshape(-1, 2),
                             seg_colors, width=3, cap="butt", **unit)
    sample_view = draw_points(sample_view, samples.reshape(-1, 2), (0.0, 0.0, 0.0), radius=4,
                              **unit)
    dot_colors = np.asarray([colors[i // s] for i in range(len(rr) * s)], np.float32)
    sample_view = draw_points(sample_view, samples.reshape(-1, 2), dot_colors, radius=3, **unit)

    return add_border(hcat(add_label(as_numpy(ray_view), "Ray View"),
                           add_label(as_numpy(sample_view), "Sample View")))
