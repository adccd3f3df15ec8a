"""Vector-graphics drawing onto images: points, line segments and camera
frusta (reference ``src/visualization/drawing/``).

Port of ``freesplat_tpu/utils/drawing.py``.  Each primitive is an exact
signed-distance field and its coverage a 1-px ramp of the distance, one
elementwise pass over (pixels, primitives); the highest-index primitive
covering a pixel wins and is alpha-blended over the image.  The
arithmetic is the JAX package's, in float32, on the image's device (CPU
for numpy input).  This module is separate from
``utils/visualization.py``'s PIL helpers.

Images are (h, w, 3) float in [0, 1], channel-last.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def _device(image):
    return image.device if torch.is_tensor(image) else torch.device("cpu")


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def _conversions(shape, device, x_range=None, y_range=None):
    """World -> pixel mapping (reference coordinate_conversion.py:19-44);
    the defaults make world == pixel coordinates."""
    h, w = shape
    x0, x1 = (0.0, float(w)) if x_range is None else map(float, x_range)
    y0, y1 = (0.0, float(h)) if y_range is None else map(float, y_range)
    minima = torch.tensor([x0, y0], dtype=torch.float32, device=device)
    scale = torch.tensor([w / (x1 - x0), h / (y1 - y0)], dtype=torch.float32, device=device)

    def world_to_pixel(xy):
        return (xy - minima) * scale

    return world_to_pixel


def _sample_grid(shape, device):
    h, w = shape
    x = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xx, yy = torch.meshgrid(x, y, indexing="xy")
    return torch.stack([xx, yy], dim=-1).reshape(-1, 2)  # (hw, 2)


def _composite(image, dist, color, feather: float = 1.0):
    """Blend primitives over the image from per-pixel signed distances
    ``dist`` (hw, n), <= 0 inside; ``color`` (n, 3).  The highest-index
    covering primitive wins."""
    h, w, _ = image.shape
    n = dist.shape[1]
    cov = torch.clamp(0.5 - dist / feather, 0.0, 1.0)  # (hw, n) coverage
    order = torch.where(cov > 0.0, torch.arange(n, dtype=torch.int32, device=dist.device),
                        torch.tensor(-1, dtype=torch.int32, device=dist.device))
    top = order.argmax(1)  # the first index of the largest, as jnp.argmax
    alpha = cov.max(1, keepdim=True).values  # (hw, 1)
    out = image.reshape(-1, 3) * (1.0 - alpha) + color[top] * alpha
    return out.reshape(h, w, 3)


def _broadcast_rows(n, device, *arrays):
    out = []
    for a, width in arrays:
        a = torch.atleast_1d(_f32(a, device))
        if width and a.dim() == 1:
            a = a[None, :]
        out.append(torch.broadcast_to(a, (n, width) if width else (n,)))
    return out


def draw_points(image, points, color=(1.0, 1.0, 1.0), radius=1.0, inner_radius=0.0,
                x_range=None, y_range=None) -> torch.Tensor:
    """Discs or rings (reference points.py:13-60)."""
    device = _device(image)
    image = _f32(image, device)
    points = torch.atleast_2d(_f32(points, device))
    n = points.shape[0]
    color, radius, inner = _broadcast_rows(n, device, (color, 3), (radius, 0),
                                           (inner_radius, 0))
    points = _conversions(image.shape[:2], device, x_range, y_range)(points)
    xy = _sample_grid(image.shape[:2], device)
    d = _norm(xy[:, None] - points[None])  # (hw, n)
    dist = torch.maximum(d - radius[None], inner[None] - d)  # ring SDF
    return _composite(image, dist, color)


def draw_lines(image, start, end, color=(1.0, 1.0, 1.0), width=1.0, cap: str = "round",
               x_range=None, y_range=None) -> torch.Tensor:
    """Line segments with butt, round or square caps (reference
    lines.py:14-81)."""
    device = _device(image)
    image = _f32(image, device)
    start = torch.atleast_2d(_f32(start, device))
    end = torch.atleast_2d(_f32(end, device))
    n = max(start.shape[0], end.shape[0])
    start = torch.broadcast_to(start, (n, 2))
    end = torch.broadcast_to(end, (n, 2))
    color, width = _broadcast_rows(n, device, (color, 3), (width, 0))
    to_pix = _conversions(image.shape[:2], device, x_range, y_range)
    start, end = to_pix(start), to_pix(end)

    xy = _sample_grid(image.shape[:2], device)  # (hw, 2)
    delta = end - start  # (n, 2)
    norm = _norm(delta)  # (n,)
    u = delta / torch.clamp(norm, min=1e-8)[:, None]
    rel = xy[:, None] - start[None]  # (hw, n, 2)
    par = (rel * u[None]).sum(-1)  # (hw, n) along-line coordinate
    if cap == "round":
        # Distance to the segment: the stadium SDF.
        t = torch.minimum(torch.clamp(par, min=0.0), norm[None])
        closest = start[None] + t[..., None] * u[None]
        dist = _norm(xy[:, None] - closest) - 0.5 * width[None]
    else:
        # Rectangle: perpendicular excess and along-line excess ("butt"
        # ends at the endpoints, "square" extends by half the width).
        extra = 0.5 * width[None] if cap == "square" else 0.0
        perp = rel - par[..., None] * u[None]
        d_perp = _norm(perp) - 0.5 * width[None]
        d_par = torch.maximum(-extra - par, par - norm[None] - extra)
        dist = torch.maximum(d_perp, d_par)
    return _composite(image, dist, color)


def _unproject_frustum_corners(extrinsics, intrinsics, depth):
    """(b, 4, 3) world-space frustum corners at ``depth`` (reference
    cameras.py:112-132): image corners unprojected through K^-1."""
    corners = torch.tensor(
        [[0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 1.0], [0.0, 1.0, 1.0]],
        dtype=torch.float32, device=extrinsics.device,
    )  # normalized image corners, counter-clockwise
    rays = torch.einsum("bij,cj->bci", torch.linalg.inv(intrinsics), corners)
    cam = rays * _f32(depth, extrinsics.device).reshape(-1, 1, 1)
    cam_h = torch.cat([cam, torch.ones_like(cam[..., :1])], dim=-1)
    return torch.einsum("bij,bcj->bci", extrinsics, cam_h)[..., :3]


def draw_cameras(resolution: int, extrinsics, intrinsics, color, near=None, far=None,
                 margin: float = 0.1, frustum_scale: float = 0.05) -> np.ndarray:
    """Three axis-aligned orthographic projections of camera frusta
    (reference cameras.py:14-109).  Returns (3, res, res, 3) numpy:
    projections along x, y, z."""
    device = _device(extrinsics)
    extrinsics = _f32(extrinsics, device)
    intrinsics = _f32(intrinsics, device)
    b = extrinsics.shape[0]
    color = torch.broadcast_to(_f32(color, device).reshape(-1, 3), (b, 3))

    origins = extrinsics[:, :3, 3]
    span_guess = torch.clamp(origins.max(0).values - origins.min(0).values, min=1e-3).max()
    frustum = _unproject_frustum_corners(extrinsics, intrinsics, span_guess * frustum_scale)
    planes = [_unproject_frustum_corners(extrinsics, intrinsics, d)
              for d in (near, far) if d is not None]
    cloud = torch.cat([origins, frustum.reshape(-1, 3), *(p.reshape(-1, 3) for p in planes)])
    minima, maxima = cloud.min(0).values, cloud.max(0).values
    # Equal AABB with margin (reference compute_equal_aabb_with_margin).
    center = 0.5 * (minima + maxima)
    half = (maxima - minima).max() * (0.5 + margin)
    minima, maxima = center - half, center + half

    ring_color = torch.repeat_interleave(color, 4, dim=0)
    views = []
    for axis in range(3):
        ax_x, ax_y = (axis + 1) % 3, (axis + 2) % 3

        def project(p):
            return torch.stack([p[..., ax_x], p[..., ax_y]], dim=-1)

        ranges = dict(x_range=(float(minima[ax_x]), float(maxima[ax_x])),
                      y_range=(float(minima[ax_y]), float(maxima[ax_y])))
        image = torch.zeros((resolution, resolution, 3), dtype=torch.float32, device=device)
        for corners in planes:
            pc = project(corners)
            image = draw_lines(image, pc.reshape(-1, 2), torch.roll(pc, 1, dims=1).reshape(-1, 2),
                               color=(0.25, 0.25, 0.25), width=2.0, **ranges)
        # Frustum wireframe: corner ring and spokes to the origin, per camera.
        pf = project(frustum)  # (b, 4, 2)
        po = project(origins)  # (b, 2)
        image = draw_lines(image, pf.reshape(-1, 2), torch.roll(pf, 1, dims=1).reshape(-1, 2),
                           color=ring_color, width=2.0, **ranges)
        image = draw_lines(image, torch.repeat_interleave(po, 4, dim=0), pf.reshape(-1, 2),
                           color=ring_color, width=2.0, **ranges)
        views.append(image.cpu().numpy())
    return np.stack(views)
