"""Epipolar geometry: ray-segment projection onto other views.

Port of ``freesplat_tpu/geometry/epipolar.py`` (reference
``src/geometry/epipolar_lines.py``: ``project_rays``, ``lift_to_3d``,
``get_depth``), fully masked and static-shape as there.  The in-bounds,
in-front and positive-t tests all allow 1e-6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import (
    get_world_rays,
    homogenize_points,
    homogenize_vectors,
    intersect_rays,
    project_camera_space,
)


class PointProjection(NamedTuple):
    t: torch.Tensor
    xy: torch.Tensor
    valid: torch.Tensor


class RaySegmentProjection(NamedTuple):
    t_min: torch.Tensor
    t_max: torch.Tensor
    xy_min: torch.Tensor
    xy_max: torch.Tensor
    overlaps_image: torch.Tensor


def _is_in_bounds(xy: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return (xy >= -epsilon).all(-1) & (xy <= 1 + epsilon).all(-1)


def _is_in_front(xyz: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return xyz[..., -1] > -epsilon


def _is_positive_t(t: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return t > -epsilon


def _intersect_image_coordinate(
    intrinsics, origins, directions, dim: int, coordinate_value: float
) -> PointProjection:
    """Intersection of the projected ray with a horizontal or vertical frame
    line (reference ``:56-105``)."""
    other = 1 - dim
    fs = intrinsics[..., dim, dim]
    fo = intrinsics[..., other, other]
    cs = intrinsics[..., dim, 2]
    co = intrinsics[..., other, 2]
    o_s = origins[..., dim]
    oo = origins[..., other]
    ds = directions[..., dim]
    do = directions[..., other]
    oz = origins[..., 2]
    dz = directions[..., 2]
    c = (coordinate_value - cs) / fs

    t = (c * oz - o_s) / (ds - c * dz)
    coord_other = co + (fo * (oo * (c * dz - ds) + do * (o_s - c * oz))) / (dz * o_s - ds * oz)
    coord_same = torch.full_like(coord_other, coordinate_value)
    parts = [coord_same]
    parts.insert(other, coord_other)
    xy = torch.stack(parts, dim=-1)
    xyz = origins + t[..., None] * directions
    valid = _is_in_bounds(xy) & _is_in_front(xyz) & _is_positive_t(t)
    valid = valid & torch.isfinite(t)  # degenerate rays are invalid anyway
    return PointProjection(torch.nan_to_num(t), torch.nan_to_num(xy), valid)


def _compare_projections(projections, reduction: str) -> PointProjection:
    t = torch.stack([p.t for p in projections])
    xy = torch.stack([p.xy for p in projections])
    valid = torch.stack([p.valid for p in projections])
    worst = torch.inf if reduction == "min" else -torch.inf
    t_masked = torch.where(valid, t, worst)
    # Ties go to the first projection, as jnp.argmin/argmax break them.
    sel = (t_masked.argmin(0) if reduction == "min" else t_masked.argmax(0))[None]
    take = lambda arr: torch.gather(arr, 0, sel)[0]  # noqa: E731
    xy_sel = torch.stack([take(xy[..., 0]), take(xy[..., 1])], dim=-1)
    return PointProjection(take(t_masked), xy_sel, take(valid.to(torch.int32)) > 0)


def _point_projection(xyz, t, intrinsics) -> PointProjection:
    xy = project_camera_space(xyz, intrinsics)
    valid = _is_in_bounds(xy) & _is_in_front(xyz) & _is_positive_t(t)
    return PointProjection(t, xy, valid)


def project_rays(
    origins: torch.Tensor,
    directions: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: torch.Tensor | None = None,
    far: torch.Tensor | None = None,
    epsilon: float = 1e-6,
) -> RaySegmentProjection:
    """Project world-space rays into another camera as image segments."""
    w2c = torch.linalg.inv(extrinsics)
    o = torch.einsum("...ij,...j->...i", w2c, homogenize_points(origins))[..., :3]
    d = torch.einsum("...ij,...j->...i", w2c, homogenize_vectors(directions))[..., :3]

    frame = [
        _intersect_image_coordinate(intrinsics, o, d, 0, 0.0),
        _intersect_image_coordinate(intrinsics, o, d, 0, 1.0),
        _intersect_image_coordinate(intrinsics, o, d, 1, 0.0),
        _intersect_image_coordinate(intrinsics, o, d, 1, 1.0),
    ]
    fmin = _compare_projections(frame, "min")
    fmax = _compare_projections(frame, "max")

    if near is None:
        at_camera = torch.linalg.norm(o, dim=-1) < epsilon
        depth_zero = o[..., -1] < epsilon
        o_proj = torch.where(at_camera[..., None], d, o)
        p0 = _point_projection(o_proj, torch.zeros_like(fmin.t), intrinsics)
        p0 = p0._replace(valid=p0.valid & ~(depth_zero & ~at_camera))
    else:
        t_near = torch.broadcast_to(near, fmin.t.shape)
        p0 = _point_projection(o + t_near[..., None] * d, t_near, intrinsics)

    if far is None:
        p1 = _point_projection(d, torch.full_like(fmax.t, torch.inf), intrinsics)
    else:
        t_far = torch.broadcast_to(far, fmax.t.shape)
        p1 = _point_projection(o + t_far[..., None] * d, t_far, intrinsics)

    # Each endpoint: the segment end's projection when valid, else the
    # frame intersection.
    return RaySegmentProjection(
        t_min=torch.where(p0.valid, p0.t, fmin.t),
        t_max=torch.where(p1.valid, p1.t, fmax.t),
        xy_min=torch.where(p0.valid[..., None], p0.xy, fmin.xy),
        xy_max=torch.where(p1.valid[..., None], p1.xy, fmax.xy),
        overlaps_image=(p0.valid | fmin.valid) & (p1.valid | fmax.valid),
    )


def lift_to_3d(origins, directions, xy, extrinsics, intrinsics) -> torch.Tensor:
    """3D points on the epipolar segment corresponding to image xy."""
    xy_origins, xy_directions = get_world_rays(xy, extrinsics, intrinsics)
    return intersect_rays(origins, directions, xy_origins, xy_directions)


def get_depth(origins, directions, xy, extrinsics, intrinsics) -> torch.Tensor:
    xyz = lift_to_3d(origins, directions, xy, extrinsics, intrinsics)
    return torch.linalg.norm(xyz - origins, dim=-1)
