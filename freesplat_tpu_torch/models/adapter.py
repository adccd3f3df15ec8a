"""GaussianAdapter: raw network features -> Gaussian parameters.

Port of ``freesplat_tpu/models/adapter.py``.  ``unproject_depth`` uses
INTEGER pixel corners (the reference's ``Create_from_depth_map`` grid),
not the +0.5 centers of the cost volume; parity depends on it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.gaussians import build_covariance
from ..ops.mathutil import safe_normalize
from ..utils.profiling import synced_inside, upload


# The least scale logit; see ``build_gaussians``.
SCALE_LOGIT_MIN = -80.0


@dataclass(frozen=True)
class GaussianAdapterCfg:
    gaussian_scale_min: float = 0.5
    gaussian_scale_max: float = 15.0
    sh_degree: int = 2

    @property
    def d_sh(self) -> int:
        return (self.sh_degree + 1) ** 2

    @property
    def d_in(self) -> int:
        """Raw feature width consumed by build_gaussians (scales+rot+sh)."""
        return 7 + 3 * self.d_sh


def sh_mask(cfg: GaussianAdapterCfg, device=None) -> torch.Tensor:
    """Bias SH toward the DC component (1 for degree 0, 0.1 * 0.25^l)."""
    mask = torch.ones(cfg.d_sh, dtype=torch.float32, device=device)
    for degree in range(1, cfg.sh_degree + 1):
        mask[degree**2 : (degree + 1) ** 2] = 0.1 * 0.25**degree
    return mask


def unproject_depth(
    depths: torch.Tensor,  # (..., h, w)
    intrinsics: torch.Tensor,  # (..., 3, 3) normalized
    extrinsics: torch.Tensor,  # (..., 4, 4) c2w
    image_shape: tuple[int, int],
) -> torch.Tensor:
    """Per-pixel world-space points (..., h, w, 3), integer pixel coords."""
    h, w = image_shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depths.device),
        torch.arange(w, dtype=torch.float32, device=depths.device),
        indexing="ij",
    )
    fx = intrinsics[..., 0, 0] * w
    fy = intrinsics[..., 1, 1] * h
    cx = intrinsics[..., 0, 2] * w
    cy = intrinsics[..., 1, 2] * h
    x = (xs - cx[..., None, None]) / fx[..., None, None] * depths
    y = (ys - cy[..., None, None]) / fy[..., None, None] * depths
    cam = torch.stack([x, y, depths], dim=-1)
    rot = extrinsics[..., :3, :3]
    t = extrinsics[..., :3, 3]
    return torch.einsum("...ij,...hwj->...hwi", rot, cam) + t[..., None, None, :]


def scale_multiplier(
    intrinsics: torch.Tensor, image_shape: tuple[int, int], multiplier: float = 0.1
) -> torch.Tensor:
    """Pixel-size scale factor (reference ``get_scale_multiplier``)."""
    h, w = image_shape
    pixel_size = upload([1.0 / w, 1.0 / h], intrinsics.device, "adapter.scale_multiplier")
    inv = torch.linalg.inv(intrinsics[..., :2, :2])
    synced_inside("adapter.scale_multiplier")
    xy = multiplier * torch.einsum("...ij,j->...i", inv, pixel_size)
    return xy.sum(-1)


def build_gaussians(
    cfg: GaussianAdapterCfg,
    raw: torch.Tensor,  # (..., 7 + 3*d_sh)
    depths: torch.Tensor,  # (...,)
    c2w_rotations: torch.Tensor,  # (..., 3, 3)
    intrinsics: torch.Tensor,  # (3, 3) normalized (current view)
    image_shape: tuple[int, int],
) -> dict[str, torch.Tensor]:
    """Raw features -> {scales, rotations, covariances, harmonics}.

    Harmonics stay in the head's frame (no world rotation: PTF path)."""
    scales_raw = raw[..., 0:3]
    rot_raw = raw[..., 3:7]
    sh = raw[..., 7:]
    s_min, s_max = cfg.gaussian_scale_min, cfg.gaussian_scale_max
    # 1 / (1 + exp(-x)) has a NaN backward where exp(-x) overflows (x < -88.7
    # in float32: 0 * inf), and one such logit among a step's Gaussians
    # makes every gradient NaN.  Clamped at SCALE_LOGIT_MIN, the scales keep
    # every bit (1 / (1 + exp(80)) = 1.8e-35 is far under the rounding of
    # any s_min > 1e-27), and the gradient below it is 0, where the exact
    # one is under 1.8e-35.
    scales_raw = scales_raw.clamp(min=SCALE_LOGIT_MIN)
    scales = s_min + (s_max - s_min) * (1.0 / (1.0 + torch.exp(-scales_raw)))
    scales = scales * depths[..., None] * scale_multiplier(intrinsics, image_shape)
    rotations = safe_normalize(rot_raw)
    sh = sh.reshape(*sh.shape[:-1], 3, cfg.d_sh) * sh_mask(cfg, raw.device)
    cov = build_covariance(scales, rotations)
    cov = c2w_rotations @ cov @ c2w_rotations.transpose(-1, -2)
    return {
        "scales": scales,
        "rotations": rotations,
        "covariances": cov,
        "harmonics": sh,
    }
