"""Gaussian parameter math: quaternions and covariance construction.

Port of ``freesplat_tpu/ops/gaussians.py`` (the reference's
``src/model/encoder/common/gaussians.py``: xyzw quaternion order,
R S S^T R^T covariance)."""
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


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) xyzw unit quaternion.

    Branch-free Shepperd-style conversion: computes all four candidate
    solutions and selects by the largest pivot (the first among equal
    pivots, as ``jnp.argmax``)."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    # Candidate quaternions (unnormalized), keyed by pivot.
    qw0 = safe_sqrt(1 + tr)
    c0 = torch.stack([(m21 - m12), (m02 - m20), (m10 - m01), qw0 * qw0], -1) / (
        2 * qw0[..., None]
    )
    qx1 = safe_sqrt(1 + m00 - m11 - m22)
    c1 = torch.stack([qx1 * qx1, (m01 + m10), (m02 + m20), (m21 - m12)], -1) / (
        2 * qx1[..., None]
    )
    qy2 = safe_sqrt(1 - m00 + m11 - m22)
    c2 = torch.stack([(m01 + m10), qy2 * qy2, (m12 + m21), (m02 - m20)], -1) / (
        2 * qy2[..., None]
    )
    qz3 = safe_sqrt(1 - m00 - m11 + m22)
    c3 = torch.stack([(m02 + m20), (m12 + m21), qz3 * qz3, (m10 - m01)], -1) / (
        2 * qz3[..., None]
    )

    pivots = torch.stack([tr, m00, m11, m22], dim=-1)
    choice = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.take_along_dim(cands, choice[..., None, None].expand(*choice.shape, 1, 4), dim=-2)
    q = q[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3, 3).

    The JAX package writes this product elementwise because XLA pads each
    tiny matrix to a full MXU tile on the TPU; on the GPU a batched matmul
    has no such padding, so it is ``a @ b``."""
    return a @ b


def build_covariance(scale: torch.Tensor, rotation_xyzw: torch.Tensor) -> torch.Tensor:
    """3D covariance Sigma = R diag(s)^2 R^T.  scale (..., 3), quat (..., 4)."""
    rotation = quaternion_to_matrix(rotation_xyzw)
    rs = rotation * scale[..., None, :]  # R @ diag(s)
    return rs @ rs.transpose(-1, -2)


def covariance_upper_triangle(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) upper triangular (row-major order)."""
    return torch.stack(
        [
            cov[..., 0, 0],
            cov[..., 0, 1],
            cov[..., 0, 2],
            cov[..., 1, 1],
            cov[..., 1, 2],
            cov[..., 2, 2],
        ],
        dim=-1,
    )
