"""Real spherical harmonics: evaluation and rotation (degrees 0..3, INRIA
3DGS order).

Port of ``freesplat_tpu/ops/sh.py``.  Rotation is numerical but exact:
each band's (2l+1)x(2l+1) rotation matrix is recovered by evaluating the
basis at a fixed set of sample directions and applying a per-band
pseudo-inverse, both computed in float64 on the host at import (the JAX
package's constants), so it is self-consistent with this basis by construction.
"""
from __future__ import annotations

import numpy as np
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


def _sample_directions(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


# Fixed sample directions and per-band pseudo-inverses (import-time constants).
_N_SAMPLES = 32
_DIRS = _sample_directions(_N_SAMPLES)
_BAND_PINV: dict[int, np.ndarray] = {}
for _l in range(4):
    # The basis in float64 on the host, as the JAX package's numpy copy of it.
    _basis = eval_sh_basis(torch.from_numpy(_DIRS), _l).numpy()[:, _l**2 : (_l + 1) ** 2]
    _BAND_PINV[_l] = np.linalg.pinv(_basis.T)  # (K, 2l+1): pinv of (2l+1, K)


def band_rotation_matrices(rotations: torch.Tensor, degree: int) -> list[torch.Tensor]:
    """Per-band real-SH rotation matrices for ``rotations`` (..., 3, 3).

    Band matrix M_l satisfies basis_l(R^T d) = M_l @ basis_l(d), so the
    function f'(d) = f(R^T d) is the lobe rotated by R."""
    mats = []
    for l in range(degree + 1):
        dirs = torch.as_tensor(_DIRS, dtype=rotations.dtype, device=rotations.device)  # (K, 3)
        rot_dirs = torch.einsum("...ij,kj->...ki", rotations.transpose(-1, -2), dirs)
        basis_rot = eval_sh_basis(rot_dirs, degree=l)[..., l**2 : (l + 1) ** 2]
        # M = B_rot^T @ pinv(B^T):  M[i, j] = sum_k B_rot[k, i] * PINV[k, j]
        pinv = torch.as_tensor(_BAND_PINV[l], dtype=rotations.dtype, device=rotations.device)
        mats.append(torch.einsum("...ki,kj->...ij", basis_rot, pinv))
    return mats


def rotate_sh(sh_coefficients: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Rotate SH coefficients (..., n) by rotation matrices (..., 3, 3).

    Defined so that ``eval_sh(rotate_sh(c, R), R @ d) == eval_sh(c, d)``:
    rotating coefficients by R makes the lobe follow directions rotated by
    R (the reference's e3nn wigner_D path,
    ``src/misc/sh_rotation.py:10-30``)."""
    n = sh_coefficients.shape[-1]
    degree = int(round(np.sqrt(n))) - 1
    assert (degree + 1) ** 2 == n, f"invalid SH coefficient count {n}"
    out = []
    for l, m in enumerate(band_rotation_matrices(rotations, degree)):
        c = sh_coefficients[..., l**2 : (l + 1) ** 2]
        # b(R^T e) = M_l b(e)  =>  c . b(R^T e) = (M_l^T c) . b(e)
        out.append(torch.einsum("...ji,...j->...i", m, c))
    return torch.cat(out, dim=-1)
