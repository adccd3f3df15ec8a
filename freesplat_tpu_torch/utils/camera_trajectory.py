"""Camera trajectories for the validation and test videos.

Port of ``freesplat_tpu/utils/camera_trajectory.py`` on torch tensors.
Parity targets: ``src/visualization/camera_trajectory/wobble.py``
(image-plane circular wobble), ``interpolation.py`` (pose slerp +
intrinsics lerp), ``spin.py`` (orbit).  The rotation slerp runs on the
host (scipy), as in JAX.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.spatial.transform import Rotation, Slerp


def generate_wobble_transformation(
    radius: torch.Tensor | float,  # (*batch,)
    t: torch.Tensor,  # (time,)
    num_rotations: int = 1,
    scale_radius_with_t: bool = True,
) -> torch.Tensor:
    """(*batch, time, 4, 4) image-plane circular offsets."""
    radius = torch.as_tensor(radius, dtype=t.dtype, device=t.device)[..., None]
    if scale_radius_with_t:
        radius = radius * t
    tx = torch.sin(2 * math.pi * num_rotations * t) * radius
    ty = -torch.cos(2 * math.pi * num_rotations * t) * radius
    tf = torch.eye(4, dtype=tx.dtype, device=tx.device).expand(*tx.shape, 4, 4).clone()
    tf[..., 0, 3] = tx
    tf[..., 1, 3] = ty
    return tf


def generate_wobble(
    extrinsics: torch.Tensor,  # (*batch, 4, 4)
    radius: torch.Tensor | float,
    t: torch.Tensor,
) -> torch.Tensor:
    tf = generate_wobble_transformation(radius, t)
    return torch.einsum("...ij,...tjk->...tik", extrinsics, tf)


def interpolate_intrinsics(
    initial: torch.Tensor, final: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """(3, 3) pair -> (time, 3, 3) linear interpolation."""
    t = t[:, None, None]
    return initial[None] + (final[None] - initial[None]) * t


def interpolate_extrinsics(
    initial: torch.Tensor, final: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """(4, 4) c2w pair -> (time, 4, 4) float32 on ``initial``'s device:
    rotation slerp + translation lerp, computed on the host in numpy with
    ``t``'s precision."""
    a = initial.detach().cpu().numpy()
    b = final.detach().cpu().numpy()
    tn = t.detach().cpu().numpy()
    slerp = Slerp([0.0, 1.0], Rotation.from_matrix(np.stack([a[:3, :3], b[:3, :3]])))
    out = np.tile(np.eye(4, dtype=np.float32), (len(tn), 1, 1))
    out[:, :3, :3] = slerp(np.clip(tn, 0.0, 1.0)).as_matrix()
    out[:, :3, 3] = a[:3, 3][None] + (b[:3, 3] - a[:3, 3])[None] * tn[:, None]
    return torch.from_numpy(out).to(initial.device)


def generate_spin(
    num_frames: int,
    elevation_deg: float,
    radius: float,
) -> torch.Tensor:
    """(time, 4, 4) float32 c2w orbit around the origin (spin.py
    equivalent), built in numpy on the host."""
    t = np.linspace(0, 2 * np.pi, num_frames, endpoint=False)
    elev = np.deg2rad(elevation_deg)
    eye = np.stack(
        [
            radius * np.cos(elev) * np.sin(t),
            -radius * np.sin(elev) * np.ones_like(t),
            -radius * np.cos(elev) * np.cos(t),
        ],
        axis=-1,
    )
    out = []
    for pos in eye:
        fwd = -pos / np.linalg.norm(pos)  # look at origin (OpenCV +z fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        e = np.eye(4, dtype=np.float32)
        e[:3, 0] = right
        e[:3, 1] = down
        e[:3, 2] = fwd
        e[:3, 3] = pos
        out.append(e)
    return torch.from_numpy(np.stack(out))
