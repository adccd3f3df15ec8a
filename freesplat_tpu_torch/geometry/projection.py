"""Camera projection math (OpenCV conventions).

Port of ``freesplat_tpu/geometry/projection.py``: extrinsics are 4x4
camera-to-world matrices in OpenCV axes (+x right, +y down, +z forward),
intrinsics are 3x3 and normalized by image size (pixel centers at
``(i + 0.5) / size``).  Shape-polymorphic over leading batch dims.
"""
from __future__ import annotations

import torch

from ..utils.profiling import synced_inside, upload

_F32_EPS = float(torch.finfo(torch.float32).eps)


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(..., d) xyz -> (..., d+1) xyz1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vectors(vectors: torch.Tensor) -> torch.Tensor:
    """(..., d) xyz -> (..., d+1) xyz0."""
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(homogeneous: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform: ``T @ p`` with broadcasting over batch dims."""
    return torch.einsum("...ij,...j->...i", transformation, homogeneous)


def transform_cam2world(homogeneous: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous, extrinsics)


def transform_world2cam(homogeneous: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous, torch.linalg.inv(extrinsics))


def project_camera_space(
    points: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = _F32_EPS,
    infinity: float = 1e8,
) -> torch.Tensor:
    """Perspective-divide then apply intrinsics. Returns (..., d-1) coords."""
    points = points / (points[..., -1:] + epsilon)
    points = torch.nan_to_num(points, nan=0.0, posinf=infinity, neginf=-infinity)
    points = torch.einsum("...ij,...j->...i", intrinsics, points)
    return points[..., :-1]


def project(
    points: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = _F32_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """World points -> normalized image coords + in-front-of-camera mask."""
    points = homogenize_points(points)
    points = transform_world2cam(points, extrinsics)[..., :-1]
    in_front = points[..., -1] >= 0
    return project_camera_space(points, intrinsics, epsilon=epsilon), in_front


def unproject(coordinates: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject normalized 2D coords at depth ``z`` into camera space."""
    coordinates = homogenize_points(coordinates)
    ray_directions = torch.einsum("...ij,...j->...i", torch.linalg.inv(intrinsics), coordinates)
    return ray_directions * z[..., None]


def get_world_rays(
    coordinates: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (origin, unit direction) in world space."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    directions = homogenize_vectors(directions)
    directions = transform_cam2world(directions, extrinsics)[..., :-1]
    origins = torch.broadcast_to(extrinsics[..., :-1, -1], directions.shape)
    return origins, directions


def sample_image_grid(
    shape: tuple[int, ...], device: str | torch.device = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized (0, 1) xy coordinates + integer ij indices for an image.

    Returns ``(coordinates[*shape, d] float xy-order, indices[*shape, d] int
    ij-order)`` with pixel centers at ``(i + 0.5) / size``."""
    indices = [torch.arange(length, device=device) for length in shape]
    stacked_indices = torch.stack(torch.meshgrid(*indices, indexing="ij"), dim=-1)
    coordinates = [(idx + 0.5) / length for idx, length in zip(indices, shape)]
    coordinates = list(reversed(coordinates))
    coordinates = torch.stack(torch.meshgrid(*coordinates, indexing="xy"), dim=-1)
    return coordinates, stacked_indices


def get_fov(intrinsics: torch.Tensor) -> torch.Tensor:
    """Horizontal/vertical FoV (radians) from normalized intrinsics: (..., 2)."""
    intrinsics_inv = torch.linalg.inv(intrinsics)
    synced_inside("projection.get_fov")

    def process(vector):
        v = upload(vector, intrinsics.device, "projection.get_fov", intrinsics.dtype)
        v = torch.einsum("...ij,j->...i", intrinsics_inv, v)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    left = process([0.0, 0.5, 1.0])
    right = process([1.0, 0.5, 1.0])
    top = process([0.5, 0.0, 1.0])
    bottom = process([0.5, 1.0, 1.0])
    fov_x = torch.arccos(torch.clamp((left * right).sum(-1), -1.0, 1.0))
    fov_y = torch.arccos(torch.clamp((top * bottom).sum(-1), -1.0, 1.0))
    return torch.stack([fov_x, fov_y], dim=-1)


def intersect_rays(
    origins_x: torch.Tensor,
    directions_x: torch.Tensor,
    origins_y: torch.Tensor,
    directions_y: torch.Tensor,
    eps: float = 1e-5,
    inf: float = 1e10,
) -> torch.Tensor:
    """Least-squares intersection of ray pairs; parallel rays -> ``inf``.

    Fully masked and static-shape, as in the JAX package: a parallel pair's
    singular system is regularized by the identity, and its answer
    overwritten with ``inf``."""
    shape = torch.broadcast_shapes(
        origins_x.shape, directions_x.shape, origins_y.shape, directions_y.shape
    )
    ox, dx, oy, dy = (torch.broadcast_to(t, shape)
                      for t in (origins_x, directions_x, origins_y, directions_y))

    parallel = (dx * dy).sum(-1) > 1 - eps

    origins = torch.stack([ox, oy], dim=0)
    directions = torch.stack([dx, dy], dim=0)

    eye = torch.eye(3, dtype=origins.dtype, device=origins.device)
    n = torch.einsum("r...i,r...j->r...ij", directions, directions) - eye
    lhs = n.sum(0)
    rhs = torch.einsum("r...ij,r...j->r...i", n, origins).sum(0)

    reg = torch.where(parallel[..., None, None], eye, torch.zeros_like(eye))
    solution = torch.einsum("...ij,...j->...i", torch.linalg.pinv(lhs + reg), rhs)
    return torch.where(parallel[..., None], torch.full_like(solution, inf), solution)
