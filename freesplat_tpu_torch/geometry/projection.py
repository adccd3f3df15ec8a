"""Camera projection math (OpenCV conventions).

Port of ``freesplat_tpu/geometry/projection.py``: extrinsics are 4x4
camera-to-world matrices, intrinsics are 3x3 and normalized by image size.
"""
from __future__ import annotations

import torch


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(..., d) xyz -> (..., d+1) xyz1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def get_fov(intrinsics: torch.Tensor) -> torch.Tensor:
    """Horizontal/vertical FoV (radians) from normalized intrinsics: (..., 2)."""
    intrinsics_inv = torch.linalg.inv(intrinsics)

    def process(vector):
        v = torch.tensor(vector, dtype=intrinsics.dtype, device=intrinsics.device)
        v = torch.einsum("...ij,j->...i", intrinsics_inv, v)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    left = process([0.0, 0.5, 1.0])
    right = process([1.0, 0.5, 1.0])
    top = process([0.5, 0.0, 1.0])
    bottom = process([0.5, 1.0, 1.0])
    fov_x = torch.arccos(torch.clamp((left * right).sum(-1), -1.0, 1.0))
    fov_y = torch.arccos(torch.clamp((top * bottom).sum(-1), -1.0, 1.0))
    return torch.stack([fov_x, fov_y], dim=-1)
