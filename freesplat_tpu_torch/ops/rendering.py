"""Shared rasterization preprocessing (plain tensor ops, autograd-friendly).

Port of ``freesplat_tpu/ops/rendering.py``: world -> camera -> pixel
projection, EWA 3x3 -> 2x2 covariance with the 0.3 px dilation,
conic/radius computation and SH -> color, with the CUDA rasterizer's
conventions (frustum cull at z <= 0.2, pixel = ((ndc + 1) * size - 1) / 2,
color = max(SH(dir) + 0.5, 0)).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.projection import get_fov, homogenize_points
from ..utils.profiling import synced_inside, upload
from .mathutil import safe_normalize
from .sh import eval_sh

TILE = 16  # pixels per rasterizer tile side
NEAR_CULL_Z = 0.2
DILATION = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TRANSMITTANCE_EPS = 1e-4


def get_projection_matrix(
    near: torch.Tensor, far: torch.Tensor, fov_x: torch.Tensor, fov_y: torch.Tensor
) -> torch.Tensor:
    """Perspective projection with Z in (0, 1), Z-flipped vs OpenGL.

    All args broadcastable; returns (..., 4, 4)."""
    tan_fov_x = torch.tan(0.5 * fov_x)
    tan_fov_y = torch.tan(0.5 * fov_y)
    top = tan_fov_y * near
    right = tan_fov_x * near
    near, far, top, right = torch.broadcast_tensors(near, far, top, right)
    zeros = torch.zeros_like(near)
    ones = torch.ones_like(near)
    r00 = 2 * near / (2 * right)
    r11 = 2 * near / (2 * top)
    r22 = far / (far - near)
    r23 = -(far * near) / (far - near)
    rows = [
        [r00, zeros, zeros, zeros],
        [zeros, r11, zeros, zeros],
        [zeros, zeros, r22, r23],
        [zeros, zeros, ones, zeros],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


class Screen(NamedTuple):
    """Per-Gaussian screen-space quantities for one view.

    means2d (n, 2) pixels; conics (n, 3) inverse 2x2 covariance (a, b, c);
    colors (n, 3); opacities (n,); depths (n,) view-space z; radii (n,)
    3-sigma pixel radius (0 when culled); mask (n,) bool.
    """

    means2d: torch.Tensor
    conics: torch.Tensor
    colors: torch.Tensor
    opacities: torch.Tensor
    depths: torch.Tensor
    radii: torch.Tensor
    mask: torch.Tensor


def preprocess_gaussians(
    means: torch.Tensor,  # (n, 3) world
    covariances: torch.Tensor,  # (n, 3, 3) world
    harmonics: torch.Tensor,  # (n, 3, d_sh)
    opacities: torch.Tensor,  # (n,)
    extrinsics: torch.Tensor,  # (4, 4) c2w
    intrinsics: torch.Tensor,  # (3, 3) normalized
    image_shape: tuple[int, int],
    sh_degree: int,
    eps: float = 1e-7,
) -> Screen:
    h, w = image_shape
    fov = get_fov(intrinsics[None])[0]
    fov_x, fov_y = fov[0], fov[1]
    tan_fov_x = torch.tan(0.5 * fov_x)
    tan_fov_y = torch.tan(0.5 * fov_y)
    focal_x = w / (2.0 * tan_fov_x)
    focal_y = h / (2.0 * tan_fov_y)

    w2c = torch.linalg.inv(extrinsics)
    synced_inside("rendering.preprocess_gaussians")
    means_h = homogenize_points(means)
    cam_pts = (means_h @ w2c.T)[:, :3]
    depths = cam_pts[:, 2]
    in_front = depths > NEAR_CULL_Z
    # Culled Gaussians stay finite: 0-cotangent * inf = NaN in a backward.
    z_safe = torch.where(in_front, depths, 1.0)

    # near/far only affect the z row, which is never read back.
    near = upload(0.01, means.device, "rendering.preprocess_gaussians", means.dtype)
    far = upload(100.0, means.device, "rendering.preprocess_gaussians", means.dtype)
    proj = get_projection_matrix(near, far, fov_x, fov_y)
    full_proj = proj @ w2c
    p_hom = means_h @ full_proj.T
    p_w = 1.0 / torch.where(in_front, p_hom[:, 3] + eps, 1.0)
    ndc = p_hom[:, :2] * p_w[:, None]
    means2d = torch.stack(
        [((ndc[:, 0] + 1.0) * w - 1.0) * 0.5, ((ndc[:, 1] + 1.0) * h - 1.0) * 0.5],
        dim=-1,
    )

    # EWA: J W Sigma W^T J^T with the CUDA clamping of the tangent-plane coords.
    lim_x = 1.3 * tan_fov_x
    lim_y = 1.3 * tan_fov_y
    tz = z_safe
    tx = torch.minimum(torch.maximum(cam_pts[:, 0] / tz, -lim_x), lim_x) * tz
    ty = torch.minimum(torch.maximum(cam_pts[:, 1] / tz, -lim_y), lim_y) * tz
    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)
    rot = w2c[:3, :3]
    jw0 = j00[:, None] * rot[0][None, :] + j02[:, None] * rot[2][None, :]
    jw1 = j11[:, None] * rot[1][None, :] + j12[:, None] * rot[2][None, :]
    c00 = covariances[:, 0, 0]
    c01 = covariances[:, 0, 1]
    c02 = covariances[:, 0, 2]
    c11 = covariances[:, 1, 1]
    c12 = covariances[:, 1, 2]
    c22 = covariances[:, 2, 2]

    def quad(u, v):
        return (
            u[:, 0] * (c00 * v[:, 0] + c01 * v[:, 1] + c02 * v[:, 2])
            + u[:, 1] * (c01 * v[:, 0] + c11 * v[:, 1] + c12 * v[:, 2])
            + u[:, 2] * (c02 * v[:, 0] + c12 * v[:, 1] + c22 * v[:, 2])
        )

    a = quad(jw0, jw0) + DILATION
    b = quad(jw0, jw1)
    c = quad(jw1, jw1) + DILATION

    det = a * c - b * b
    nondegenerate = det > 0.0
    det_safe = torch.where(nondegenerate, det, 1.0)
    conics = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    # Opacity-aware radius, capped at 3 sigma (the CUDA spec).  Detached:
    # sqrt(0) at op <= ALPHA_MIN would make its cotangent 0 * inf = NaN.
    k_sigma = torch.clamp(
        torch.sqrt(
            2.0 * torch.clamp(
                torch.log(torch.clamp(opacities, min=1e-12) / ALPHA_MIN), min=0.0
            )
        ),
        max=3.0,
    ).detach()
    radii = torch.ceil(k_sigma * torch.sqrt(torch.clamp(lambda1, min=0.0)))

    campos = extrinsics[:3, 3]
    dirs = safe_normalize(means - campos)
    colors = torch.clamp(eval_sh(harmonics, dirs, sh_degree) + 0.5, min=0.0)

    mask = in_front & nondegenerate & (radii > 0)
    radii = torch.where(mask, radii, 0.0)
    return Screen(
        means2d=means2d,
        conics=conics,
        colors=colors,
        opacities=opacities,
        depths=depths,
        radii=radii,
        mask=mask,
    )
