"""Epipolar line sampler (the legacy pixelSplat stack, for visualization).

Port of ``freesplat_tpu/models/epipolar_sampler.py`` (reference
``src/model/encoder/epipolar/epipolar_sampler.py``): for every (view,
other-view) pair, cast a ray through each pixel of the first view,
project it into the other view as an image-space segment (clipped by
near/far and the frame), place ``num_samples`` evenly spaced samples
along the segment (fractions (s + 0.5)/S), and sample the other view's
feature map there bilinearly (``ops/grid_sample.py::bilinear_sample``).
Rays whose segment misses the frame are zeroed and flagged invalid.  It
has no parameters, so it is a plain class.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.epipolar import project_rays
from ..geometry.pairings import (
    generate_heterogeneous_index,
    generate_heterogeneous_index_transpose,
)
from ..geometry.projection import get_world_rays, sample_image_grid
from ..ops.grid_sample import bilinear_sample


class EpipolarSampling(NamedTuple):
    features: torch.Tensor  # (b, v, ov, r, s, c)
    valid: torch.Tensor  # (b, v, ov, r) bool
    xy_ray: torch.Tensor  # (b, v, r, 2) normalized xy of the casting pixel
    xy_sample: torch.Tensor  # (b, v, ov, r, s, 2)
    xy_sample_near: torch.Tensor  # (b, v, ov, r, s, 2)
    xy_sample_far: torch.Tensor  # (b, v, ov, r, s, 2)
    origins: torch.Tensor  # (b, v, r, 3)
    directions: torch.Tensor  # (b, v, r, 3)


class EpipolarSampler:
    """Samples features along epipolar lines in paired views."""

    def __init__(self, num_views: int, num_samples: int):
        self.num_samples = num_samples
        _, index_v = generate_heterogeneous_index(num_views)
        t_v, t_ov = generate_heterogeneous_index_transpose(num_views)
        self.index_v = torch.from_numpy(index_v).long()
        self.transpose_v = torch.from_numpy(t_v).long()
        self.transpose_ov = torch.from_numpy(t_ov).long()

    def collect(self, target: torch.Tensor) -> torch.Tensor:
        """(b, v, ...) -> (b, v, ov, ...): each view's paired other-views."""
        return target[:, self.index_v.to(target.device)]

    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        """Swap ray-casting view for sampled view on (b, v, ov, ...)."""
        return x[:, self.transpose_v.to(x.device), self.transpose_ov.to(x.device)]

    def __call__(
        self,
        images: torch.Tensor,  # (b, v, h, w, c) NHWC
        extrinsics: torch.Tensor,  # (b, v, 4, 4)
        intrinsics: torch.Tensor,  # (b, v, 3, 3) normalized
        near: torch.Tensor,  # (b, v)
        far: torch.Tensor,  # (b, v)
    ) -> EpipolarSampling:
        b, v, h, w, c = images.shape
        s = self.num_samples

        # Pixel-grid rays in world space.
        xy, _ = sample_image_grid((h, w), device=images.device)
        xy = xy.reshape(-1, 2).to(images.dtype)  # (r, 2)
        origins, directions = get_world_rays(
            xy, extrinsics[:, :, None], intrinsics[:, :, None]
        )  # (b, v, r, 3)

        proj = project_rays(
            origins[:, :, None],  # (b, v, 1, r, 3)
            directions[:, :, None],
            self.collect(extrinsics)[:, :, :, None],  # (b, v, ov, 1, 4, 4)
            self.collect(intrinsics)[:, :, :, None],
            near[:, :, None, None],
            far[:, :, None, None],
        )

        # Evenly spaced fractions along each ray's visible segment.
        frac = ((torch.arange(s, device=images.device, dtype=images.dtype) + 0.5) / s)[:, None]
        ok = proj.overlaps_image[..., None]  # (b, v, ov, r, 1)
        xy_min = torch.nan_to_num(proj.xy_min, posinf=0.0, neginf=0.0) * ok
        xy_max = torch.nan_to_num(proj.xy_max, posinf=0.0, neginf=0.0) * ok
        span = xy_max[..., None, :] - xy_min[..., None, :]
        xy_sample = xy_min[..., None, :] + frac * span  # (b, v, ov, r, s, 2)

        # Sample the *other* view's features: transpose so that the view
        # axis is the sampled view, gather, transpose back.
        samples_xy = self.transpose(xy_sample)
        pix = samples_xy * torch.tensor([w, h], dtype=samples_xy.dtype, device=images.device)
        ov = pix.shape[2]
        sampled = bilinear_sample(
            images.reshape(b * v, h, w, c),
            pix.reshape(b * v, ov * pix.shape[3] * s, 2),
        ).reshape(b, v, ov, -1, s, c)
        sampled = self.transpose(sampled)
        sampled = sampled * ok[..., None]

        half = 0.5 / s
        return EpipolarSampling(
            features=sampled,
            valid=proj.overlaps_image,
            xy_ray=torch.broadcast_to(xy, (b, v, h * w, 2)),
            xy_sample=xy_sample,
            xy_sample_near=xy_min[..., None, :] + (frac - half) * span,
            xy_sample_far=xy_min[..., None, :] + (frac + half) * span,
            origins=origins,
            directions=directions,
        )
