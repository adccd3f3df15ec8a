"""Gaussian parameter math: quaternions and covariance construction."""
from __future__ import annotations

import torch


def quaternion_to_matrix(quaternions: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 4) xyzw quaternion -> (..., 3, 3) rotation matrix.

    Tolerates unnormalized quaternions (normalizes via the 2/|q|^2 factor).
    """
    i, j, k, r = quaternions.unbind(-1)
    two_s = 2.0 / ((quaternions * quaternions).sum(-1) + eps)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(*o.shape[:-1], 3, 3)


def build_covariance(scale: torch.Tensor, rotation_xyzw: torch.Tensor) -> torch.Tensor:
    """3D covariance Sigma = R diag(s)^2 R^T.  scale (..., 3), quat (..., 4)."""
    rotation = quaternion_to_matrix(rotation_xyzw)
    rs = rotation * scale[..., None, :]  # R @ diag(s)
    return rs @ rs.transpose(-1, -2)
