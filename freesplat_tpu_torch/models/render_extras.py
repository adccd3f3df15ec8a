"""Auxiliary rendering modes: orthographic projections and depth as color.

Port of ``freesplat_tpu/models/render_extras.py`` (reference
``cuda_splatting.py``: ``render_cuda_orthographic``, a camera pushed far
back with a narrow field of view, used by the 3D validation views
``visualization/validation_in_3d.py``; and ``render_depth_cuda``, each
Gaussian's camera-space z rendered as a DC color).  Renders go through
``ops/rasterizer.py::rasterize``, so on the card through the forward
kernel; ``use_reference=True`` takes the dense
``ops/rasterizer_ref.py::render_reference`` instead (the JAX package's
``use_pallas=False``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.projection import homogenize_points
from ..ops.rasterizer import rasterize
from ..ops.rasterizer_ref import render_reference
from .types import Gaussians


def depth_to_relative_disparity(depth: torch.Tensor, near, far) -> torch.Tensor:
    """Disparity remapped so near -> 0 and far -> 1 (reference
    ``encoder/epipolar/conversions.py``)."""
    disp_near = 1.0 / near
    disp_far = 1.0 / far
    return (1.0 / depth - disp_near) / (disp_far - disp_near)


def orthographic_camera(
    extrinsics: torch.Tensor, width: float, height: float, fov_degrees: float = 0.1
) -> tuple[torch.Tensor, torch.Tensor]:
    """(extrinsics, normalized intrinsics) of the near-orthographic camera:
    ``extrinsics`` moved back along its view axis until a field of view of
    ``fov_degrees`` spans ``width``."""
    tan_fov_x = math.tan(0.5 * math.radians(fov_degrees))
    distance_to_near = (0.5 * width) / tan_fov_x
    tan_fov_y = 0.5 * height / distance_to_near
    intrinsics = torch.tensor(
        [[0.5 / tan_fov_x, 0.0, 0.5], [0.0, 0.5 / tan_fov_y, 0.5], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=extrinsics.device,
    )
    move_back = torch.eye(4, dtype=extrinsics.dtype, device=extrinsics.device)
    move_back[2, 3] = -distance_to_near
    return extrinsics @ move_back, intrinsics


def render_orthographic(
    gaussians: Gaussians,
    extrinsics: torch.Tensor,  # (4, 4)
    width: float,
    height: float,
    near: float,
    far: float,
    image_shape: tuple[int, int],
    background: torch.Tensor,
    sh_degree: int,
    fov_degrees: float = 0.1,
    use_reference: bool = False,
) -> torch.Tensor:
    """Approximate orthographic render (h, w, 3): the camera moved far back
    with a narrow field of view, so that rays are near-parallel."""
    extrinsics, intrinsics = orthographic_camera(extrinsics, width, height, fov_degrees)
    render = render_reference if use_reference else rasterize
    color, _, _ = render(gaussians.means, gaussians.covariances, gaussians.harmonics,
                         gaussians.masked_opacities(), extrinsics, intrinsics, image_shape,
                         background, sh_degree)
    return color


def projection_views(means: torch.Tensor, margin: float = 0.1):
    """The three axis-aligned cameras of ``render_projections`` for a cloud
    of ``means`` (g, 3): a list of (extrinsics (4, 4), width, height,
    depth), looking down x, y and z from the equal bounding box's face
    (reference ``validation_in_3d.py:25-89``)."""
    from ..utils.camera_viz import compute_equal_aabb_with_margin

    pts = means.detach().cpu().numpy()
    scene_min, scene_max = compute_equal_aabb_with_margin(pts.min(axis=0), pts.max(axis=0),
                                                          margin)
    center = 0.5 * (scene_min + scene_max)
    extent = scene_max - scene_min
    views = []
    for look_axis in range(3):
        right_axis = (look_axis + 1) % 3
        down_axis = (look_axis + 2) % 3
        extr = np.zeros((4, 4), np.float32)
        extr[right_axis, 0] = 1.0
        extr[down_axis, 1] = 1.0
        extr[look_axis, 2] = 1.0
        extr[right_axis, 3] = center[right_axis]
        extr[down_axis, 3] = center[down_axis]
        extr[look_axis, 3] = scene_min[look_axis]
        extr[3, 3] = 1.0
        views.append((torch.from_numpy(extr).to(means.device), float(extent[right_axis]),
                       float(extent[down_axis]), float(extent[look_axis])))
    return views


def render_projections(
    gaussians: Gaussians,
    resolution: int = 256,
    margin: float = 0.1,
    use_reference: bool = False,
) -> torch.Tensor:
    """Three axis-aligned orthographic projections of one scene's Gaussians
    (fov 10 degrees, black background, DC color): (3, resolution,
    resolution, 3)."""
    background = torch.zeros(3, device=gaussians.means.device)
    return torch.stack([
        render_orthographic(gaussians, extr, width, height, 0.0, depth,
                            (resolution, resolution), background, sh_degree=0,
                            fov_degrees=10.0, use_reference=use_reference)
        for extr, width, height, depth in projection_views(gaussians.means, margin)
    ])


def render_depth(
    gaussians: Gaussians,
    extrinsics: torch.Tensor,  # (4, 4)
    intrinsics: torch.Tensor,  # (3, 3) normalized
    near: torch.Tensor,
    far: torch.Tensor,
    image_shape: tuple[int, int],
    mode: str = "depth",  # depth | disparity | relative_disparity | log
    use_reference: bool = False,
) -> torch.Tensor:
    """Render camera-space z as a DC-only color (render_depth_cuda): (h, w)."""
    w2c = torch.linalg.inv(extrinsics)
    cam = torch.einsum("ij,nj->ni", w2c, homogenize_points(gaussians.means))[:, 2]
    fake = cam
    if mode == "disparity":
        fake = 1.0 / torch.clamp(cam, min=1e-8)
    elif mode == "relative_disparity":
        fake = depth_to_relative_disparity(torch.clamp(cam, min=1e-8), near, far)
    elif mode == "log":
        fake = torch.log(torch.minimum(torch.maximum(cam, near), far))

    # DC-only SH that evaluates exactly to ``fake`` (the inverse of the
    # +0.5 offset and the C0 basis factor).
    c0 = 0.28209479177387814
    dc = (fake - 0.5) / c0
    harmonics = dc[:, None, None].expand(-1, 3, 1)  # (g, 3, 1)

    render = render_reference if use_reference else rasterize
    color, _, _ = render(gaussians.means, gaussians.covariances, harmonics,
                         gaussians.masked_opacities(), extrinsics, intrinsics, image_shape,
                         torch.zeros(3, device=cam.device), 0)
    return color.mean(-1)
