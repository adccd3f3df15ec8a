"""Auxiliary depth losses (reference ``src/loss/losses.py``).

Port of ``freesplat_tpu/training/depth_losses.py``: multi-scale gradient
loss, Eigen scale-invariant loss, normals loss and a multi-view depth
consistency loss.  Depth maps are (b, h, w), normals (b, h, w, 3).
``F.conv2d`` is a cross-correlation like ``lax.conv_general_dilated``, so
the kernels are used as written there, not flipped.  Masked terms go
through ``torch.where``, whose backward sends nothing to the branch not
taken, so NaN holes in a ground truth reach neither value nor gradient,
as under ``jax.grad``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.gather import take_rows

_BINOMIAL = (1.0, 2.0, 1.0)
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _blur_pool2(x: torch.Tensor) -> torch.Tensor:
    """3x3 binomial blur + stride-2 downsample (kornia blur_pool2d analog),
    reflect-padded.  x: (b, h, w)."""
    k = torch.tensor(_BINOMIAL, dtype=x.dtype, device=x.device)
    kernel = (k[:, None] * k[None, :]) / 16.0
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="reflect")
    return F.conv2d(xp, kernel[None, None], stride=2)[:, 0]


def pyrdown(x: torch.Tensor, num_scales: int = 4) -> list[torch.Tensor]:
    """Blur-pool pyramid (sr_utils/generic_utils.py pyrdown)."""
    out = [x]
    for _ in range(num_scales - 1):
        out.append(_blur_pool2(out[-1]))
    return out


def _spatial_gradient(x: torch.Tensor) -> torch.Tensor:
    """Normalized Sobel x/y gradients, zero-padded SAME (kornia
    convention): (b, h, w) -> (b, 2, h, w)."""
    sx = torch.tensor(_SOBEL_X, dtype=x.dtype, device=x.device) / 8.0
    kernels = torch.stack([sx, sx.T])[:, None]  # (2, 1, 3, 3)
    return F.conv2d(x[:, None], kernels, padding=1)


def ms_gradient_loss(
    depth_gt: torch.Tensor, depth_pred: torch.Tensor, num_scales: int = 4
) -> torch.Tensor:
    """Multi-scale depth gradient L1 (MSGradientLoss).  Non-finite gt
    gradients are masked out."""
    total = depth_pred.new_zeros(())
    for gt_s, pred_s in zip(pyrdown(depth_gt, num_scales), pyrdown(depth_pred, num_scales)):
        g_gt = _spatial_gradient(gt_s)
        g_pr = _spatial_gradient(pred_s)
        mask = torch.isfinite(g_gt).all(dim=1, keepdim=True)
        diff = torch.where(mask, g_pr - torch.nan_to_num(g_gt), torch.zeros_like(g_pr))
        denom = torch.clamp(mask.sum() * 2, min=1)
        total = total + diff.abs().sum() / denom
    return total


def scale_invariant_loss(
    log_depth_gt: torch.Tensor,
    log_depth_pred: torch.Tensor,
    si_lambda: float = 0.85,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Eigen scale-invariant log-depth loss (ScaleInvariantLoss)."""
    diff = log_depth_gt - log_depth_pred
    if mask is not None:
        n = torch.clamp(mask.sum(), min=1)
        diff = torch.where(mask, diff, torch.zeros_like(diff))
        mean_sq = (diff**2).sum() / n
        mean = diff.sum() / n
    else:
        mean_sq = (diff**2).mean()
        mean = diff.mean()
    return torch.sqrt(torch.clamp(mean_sq - si_lambda * mean**2, min=1e-12))


def normals_loss(normals_gt: torch.Tensor, normals_pred: torch.Tensor) -> torch.Tensor:
    """0.5 * (1 - cos similarity), masked at non-finite entries.
    normals: (b, h, w, 3)."""
    mask = (torch.isfinite(normals_gt) & torch.isfinite(normals_pred)).all(dim=-1)
    one = torch.ones_like(normals_pred)
    gt = torch.where(mask[..., None], torch.nan_to_num(normals_gt), one)
    pr = torch.where(mask[..., None], torch.nan_to_num(normals_pred), one)
    dot = 0.5 * (1.0 - (gt * pr).sum(dim=-1))
    return torch.where(mask, dot, torch.zeros_like(dot)).sum() / torch.clamp(mask.sum(), min=1)


def _pixel_grid(h: int, w: int, like: torch.Tensor):
    ys = torch.arange(h, dtype=torch.float32, device=like.device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=like.device) + 0.5
    return torch.meshgrid(ys, xs, indexing="ij")


def depth_to_normals(
    depth: torch.Tensor,  # (b, h, w)
    intrinsics: torch.Tensor,  # (3, 3) pixel units
) -> torch.Tensor:
    """Normals from a depth map via cross products of backprojected
    neighbours (sr_utils NormalGenerator analog, without the blur).
    Returns (b, h, w, 3)."""
    _, h, w = depth.shape
    ys, xs = _pixel_grid(h, w, depth)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (xs - cx) / fx * depth
    y = (ys - cy) / fy * depth
    pts = torch.stack([x, y, depth], dim=-1)  # (b, h, w, 3)
    dx = torch.roll(pts, -1, dims=2) - pts
    dy = torch.roll(pts, -1, dims=1) - pts
    n = torch.linalg.cross(dy, dx, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.clamp(norm, min=1e-8)


def mv_depth_loss(
    cur_depth: torch.Tensor,  # (b, h, w) predicted depth in current view
    src_depth: torch.Tensor,  # (b, h, w) predicted depth in source view
    cur_extrinsics: torch.Tensor,  # (b, 4, 4) c2w
    src_extrinsics: torch.Tensor,  # (b, 4, 4) c2w
    intrinsics: torch.Tensor,  # (3, 3) pixel units (shared)
) -> torch.Tensor:
    """Multi-view depth consistency (MVDepthLoss): backproject the current
    depth, project it into the source view and compare with the source
    depth at the nearest pixel there (L1 on log depth, masked to
    non-occluded points)."""
    b, h, w = cur_depth.shape
    ys, xs = _pixel_grid(h, w, cur_depth)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (xs[None] - cx) / fx * cur_depth
    y = (ys[None] - cy) / fy * cur_depth
    cam = torch.stack([x, y, cur_depth, torch.ones_like(cur_depth)], dim=-1)
    src_T_cur = torch.linalg.inv(src_extrinsics) @ cur_extrinsics  # (b, 4, 4)
    src_pts = torch.einsum("bij,bhwj->bhwi", src_T_cur, cam)[..., :3]
    z = src_pts[..., 2]
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    u = src_pts[..., 0] / z_safe * fx + cx
    v = src_pts[..., 1] / z_safe * fy + cy
    ui = torch.clamp(torch.round(u - 0.5).long(), 0, w - 1)
    vi = torch.clamp(torch.round(v - 0.5).long(), 0, h - 1)
    # The same gather as torch.gather along pixels, with a gradient that
    # sums in a fixed order (``ops/gather.py``).
    flat = (vi * w + ui).reshape(b, h * w) + h * w * torch.arange(b, device=ui.device)[:, None]
    sampled = take_rows(src_depth.reshape(b * h * w), flat.reshape(-1)).reshape(b, h, w)
    in_bounds = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z > 0)
    mask = in_bounds & (z < 1.05 * sampled) & (sampled > 0)
    eps = torch.full_like(z, 1e-6)
    err = torch.abs(torch.log(torch.maximum(z, eps)) - torch.log(torch.maximum(sampled, eps)))
    return (torch.where(mask, err, torch.zeros_like(err)).sum()
            / torch.clamp(mask.sum(), min=1))
