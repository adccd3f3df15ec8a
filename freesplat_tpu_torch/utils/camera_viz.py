"""Camera-frustum visualization: wireframe cameras projected onto the
three axis-aligned planes.

Port of ``freesplat_tpu/utils/camera_viz.py`` (reference
``src/visualization/drawing/cameras.py:14-121`` ``draw_cameras`` and
``validation_in_3d.py:92-121`` ``render_cameras``).  Host-side numpy,
drawn through ``utils/visualization.py``'s PIL helpers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .visualization import add_label, as_numpy, draw_lines


def unproject_frustum_corners(
    extrinsics: np.ndarray,  # (b, 4, 4) c2w
    intrinsics: np.ndarray,  # (b, 3, 3) normalized
    depth: np.ndarray,  # scalar or (b,)
) -> np.ndarray:
    """World-space frustum rectangle corners at ``depth`` (b, 4, 3),
    walked in a circle (reference cameras.py:168-195)."""
    b = extrinsics.shape[0]
    xy = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    k_inv = np.linalg.inv(intrinsics)  # (b, 3, 3)
    homo = np.concatenate([xy, np.ones((4, 1), np.float32)], -1)  # (4, 3)
    directions = np.einsum("bij,pj->bpi", k_inv, homo)
    directions = directions / directions[..., -1:]  # z-depth scaling
    directions = np.einsum("bij,bpj->bpi", extrinsics[:, :3, :3], directions)
    origins = extrinsics[:, None, :3, 3]
    depth = np.broadcast_to(np.asarray(depth, np.float32), (b,))
    return origins + depth[:, None, None] * directions


def compute_equal_aabb_with_margin(
    minima: np.ndarray, maxima: np.ndarray, margin: float = 0.1
) -> tuple[np.ndarray, np.ndarray]:
    midpoint = 0.5 * (maxima + minima)
    span = (maxima - minima).max() * (1 + margin)
    return midpoint - 0.5 * span, midpoint + 0.5 * span


def draw_cameras(
    resolution: int,
    extrinsics: np.ndarray,  # (b, 4, 4) c2w
    intrinsics: np.ndarray,  # (b, 3, 3) normalized
    color: np.ndarray,  # (b, 3)
    near: Optional[np.ndarray] = None,
    far: Optional[np.ndarray] = None,
    margin: float = 0.1,
    frustum_scale: float = 0.05,
) -> np.ndarray:
    """(3, resolution + label, resolution, 3) labeled axis-plane projections
    of the camera wireframes, with the near and far planes in gray when
    given."""
    extrinsics = np.asarray(extrinsics, np.float32)
    intrinsics = np.asarray(intrinsics, np.float32)
    color = np.asarray(color, np.float32)

    # The bounding box of the camera origins and near/far frustum corners.
    points = [extrinsics[:, :3, 3]]
    if near is not None:
        near_corners = unproject_frustum_corners(extrinsics, intrinsics, near)
        points.append(near_corners.reshape(-1, 3))
    if far is not None:
        far_corners = unproject_frustum_corners(extrinsics, intrinsics, far)
        points.append(far_corners.reshape(-1, 3))
    pts = np.concatenate(points, 0)
    scene_min, scene_max = compute_equal_aabb_with_margin(pts.min(0), pts.max(0), margin)
    span = (scene_max - scene_min).max()
    frustum_corners = unproject_frustum_corners(extrinsics, intrinsics, span * frustum_scale)

    views = []
    for axis in range(3):
        ax_x = (axis + 1) % 3
        ax_y = (axis + 2) % 3
        image = np.zeros((resolution, resolution, 3), np.float32)

        def project(p):
            # Normalized [0, 1] plane coordinates for draw_lines.
            x = (p[..., ax_x] - scene_min[ax_x]) / (scene_max[ax_x] - scene_min[ax_x])
            y = (p[..., ax_y] - scene_min[ax_y]) / (scene_max[ax_y] - scene_min[ax_y])
            return np.stack([x, y], -1)

        def rect_edges(corners):  # (b, 4, 2) -> start/end lists
            return corners.reshape(-1, 2), np.roll(corners, 1, axis=1).reshape(-1, 2)

        gray = (0.25, 0.25, 0.25)
        if near is not None:
            image = draw_lines(image, *rect_edges(project(near_corners)), color=gray, width=2)
        if far is not None:
            image = draw_lines(image, *rect_edges(project(far_corners)), color=gray, width=2)
        if near is not None and far is not None:
            image = draw_lines(image, project(near_corners).reshape(-1, 2),
                               project(far_corners).reshape(-1, 2), color=gray, width=2)

        origins = project(extrinsics[:, :3, 3])
        corners = project(frustum_corners)  # (b, 4, 2)
        rolled = np.roll(corners, 1, axis=1)
        for bi in range(extrinsics.shape[0]):
            c = tuple(color[bi])
            image = draw_lines(image, np.repeat(origins[bi:bi + 1], 4, 0), corners[bi],
                               color=c, width=2)
            image = draw_lines(image, rolled[bi], corners[bi], color=c, width=2)
        views.append(add_label(image, f"{'XYZ'[ax_x]}{'XYZ'[ax_y]} Projection"))
    # Pad the labeled views to a common shape before stacking.
    hmax = max(v.shape[0] for v in views)
    wmax = max(v.shape[1] for v in views)
    views = [np.pad(v, ((0, hmax - v.shape[0]), (0, wmax - v.shape[1]), (0, 0)),
                    constant_values=1.0) for v in views]
    return np.stack(views)


def render_cameras(batch: dict, resolution: int = 256) -> np.ndarray:
    """Context (white) and target (red) camera wireframes of scene 0
    (reference validation_in_3d.py:92-121)."""
    ctx, tgt = batch["context"], batch["target"]
    n_ctx = as_numpy(ctx["extrinsics"]).shape[1]
    n_tgt = as_numpy(tgt["extrinsics"]).shape[1]
    color = np.ones((n_ctx + n_tgt, 3), np.float32)
    color[n_ctx:, 1:] = 0.0  # targets in red

    def both(key):
        return np.concatenate([as_numpy(ctx[key])[0], as_numpy(tgt[key])[0]])

    return draw_cameras(resolution, both("extrinsics"), both("intrinsics"), color,
                        near=both("near"), far=both("far"))
