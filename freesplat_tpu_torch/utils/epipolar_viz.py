"""Epipolar-sampling visualization for the legacy pixelSplat-style stack.

Port of ``freesplat_tpu/utils/epipolar_viz.py`` (reference
``encoder/visualization/encoder_visualizer_epipolar.py``): the casting
pixel in one view and its sampled epipolar segment in the paired view,
drawn with ``utils/visualization.py``'s PIL helpers.
"""
from __future__ import annotations

import numpy as np

from ..geometry.pairings import generate_heterogeneous_index
from .visualization import add_label, as_numpy, draw_lines, draw_points, hcat


def visualize_epipolar_sampling(
    images,  # (v, h, w, 3) context images, [0, 1]
    sampling,  # models.epipolar_sampler.EpipolarSampling (batch b=1)
    ray_index: int | None = None,
    view: int = 0,
    other_view: int = 0,
) -> np.ndarray:
    """Side by side: the ray-casting pixel (red dot) in ``view`` and its
    epipolar segment (yellow line, green sample dots) in the paired
    ``other_view``.  ``ray_index`` defaults to the central pixel."""
    images = as_numpy(images)
    v, h, w, _ = images.shape
    xy_ray = as_numpy(sampling.xy_ray[0])  # (v, r, 2)
    xy_sample = as_numpy(sampling.xy_sample[0])  # (v, ov, r, s, 2)
    xy_near = as_numpy(sampling.xy_sample_near[0])
    xy_far = as_numpy(sampling.xy_sample_far[0])
    valid = as_numpy(sampling.valid[0])  # (v, ov, r)

    r = xy_ray.shape[1]
    if ray_index is None:
        ray_index = (h // 2) * w + w // 2 if r == h * w else r // 2

    left = draw_points(images[view], xy_ray[view, ray_index][None], color=(1, 0, 0), radius=3)
    left = add_label(left, f"view {view}: casting pixel")

    # collect() pairs each view with the other views in order, so
    # other_view indexes that list.
    _, index_v = generate_heterogeneous_index(v)
    paired = int(index_v[view, other_view])

    right = images[paired]
    if bool(valid[view, other_view, ray_index]):
        seg = np.stack([xy_near[view, other_view, ray_index, 0],
                        xy_far[view, other_view, ray_index, -1]])
        right = draw_lines(right, seg[:1], seg[1:], color=(1, 1, 0), width=2)
        right = draw_points(right, xy_sample[view, other_view, ray_index], color=(0, 1, 0),
                            radius=1)
    right = add_label(right, f"view {paired}: epipolar samples")
    return hcat(left, right)
