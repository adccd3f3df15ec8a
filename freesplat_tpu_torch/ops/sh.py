"""Real spherical harmonics evaluation (degrees 0..3, INRIA 3DGS order)."""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_basis(directions: torch.Tensor, degree: int) -> torch.Tensor:
    """Evaluate the SH basis at unit ``directions`` (..., 3) -> (..., (deg+1)^2)."""
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(sh: torch.Tensor, directions: torch.Tensor, degree: int) -> torch.Tensor:
    """SH colors: sh (..., channels, (deg+1)^2), directions (..., 3) unit.

    Returns (..., channels) = basis . coeffs (no +0.5 offset / clamping)."""
    basis = eval_sh_basis(directions, degree)
    return (sh * basis[..., None, :]).sum(-1)
