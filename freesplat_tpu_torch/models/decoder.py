"""Decoder: Gaussians -> rendered target views.

Port of ``freesplat_tpu/models/decoder.py``: per-view rendering with the
scale-invariant 1/near rescale, the dataset background color and three
depth conventions ('depth' = alpha-normalized expected depth, 'ref_compat'
= the reference's depth / 2, 'raw' = unnormalized).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..ops.rasterizer import rasterize, render_capacity
from ..ops.rasterizer_ref import render_reference
from ..utils.device import resolve_device
from .types import Gaussians


@dataclass(frozen=True)
class DecoderCfg:
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale_invariant: bool = True
    sh_degree: int = 2
    depth_mode: str = "depth"  # 'depth' | 'ref_compat' | 'raw'
    use_reference_rasterizer: bool = False  # dense golden path (slow)
    # Static instance budget = render_capacity(num_gaussians, factor).
    capacity_factor: float = 3.0


class DecoderOutput(NamedTuple):
    color: torch.Tensor  # (b, v, h, w, 3)
    depth: torch.Tensor  # (b, v, h, w)
    alpha: torch.Tensor  # (b, v, h, w)
    # (b, v) instances cut by the capacity budget / per-tile cap.
    dropped: torch.Tensor | None = None


def render_view(
    cfg: DecoderCfg,
    gaussians: Gaussians,  # unbatched: (g, ...)
    extrinsics: torch.Tensor,  # (4, 4)
    intrinsics: torch.Tensor,  # (3, 3) normalized
    near: torch.Tensor,  # ()
    far: torch.Tensor,  # ()
    image_shape: tuple[int, int],
):
    """Returns (color (h, w, 3), depth (h, w), alpha (h, w), dropped ())."""
    means = gaussians.means
    covs = gaussians.covariances
    opac = gaussians.masked_opacities()
    background = torch.tensor(
        cfg.background_color, dtype=torch.float32, device=means.device
    )
    if cfg.scale_invariant:
        # Rescale the scene by 1/near so numerics stay in a good range.
        s = 1.0 / near
        extrinsics = extrinsics.clone()
        extrinsics[:3, 3] = extrinsics[:3, 3] * s
        means = means * s
        covs = covs * (s * s)

    if cfg.use_reference_rasterizer:
        color, depth_acc, alpha = render_reference(
            means, covs, gaussians.harmonics, opac, extrinsics, intrinsics,
            image_shape, background, cfg.sh_degree,
        )
        dropped = torch.zeros((), dtype=torch.int64, device=means.device)
    else:
        color, depth_acc, alpha, stats = rasterize(
            means, covs, gaussians.harmonics, opac, extrinsics, intrinsics,
            image_shape, background, cfg.sh_degree,
            capacity=render_capacity(means.shape[0], cfg.capacity_factor),
            return_stats=True,
        )
        dropped = stats["dropped"]
    if cfg.scale_invariant:
        depth_acc = depth_acc * near  # undo the rescale on view-space z

    if cfg.depth_mode == "ref_compat":
        depth = depth_acc / 2.0
    elif cfg.depth_mode == "depth":
        depth = depth_acc / torch.clamp(alpha, min=1e-6)
    else:
        depth = depth_acc
    return color, depth, alpha, dropped


def render_views(
    cfg: DecoderCfg,
    gaussians: Gaussians,  # (b, g, ...)
    extrinsics: torch.Tensor,  # (b, v, 4, 4)
    intrinsics: torch.Tensor,  # (b, v, 3, 3)
    near: torch.Tensor,  # (b, v)
    far: torch.Tensor,  # (b, v)
    image_shape: tuple[int, int],
) -> DecoderOutput:
    """Render every (batch, view) pair, one view at a time."""
    b, v = extrinsics.shape[:2]
    outs = []
    for bi in range(b):
        g = Gaussians(*(x[bi] if x is not None else None for x in gaussians))
        for vi in range(v):
            outs.append(render_view(
                cfg, g, extrinsics[bi, vi], intrinsics[bi, vi],
                near[bi, vi], far[bi, vi], image_shape,
            ))
    color, depth, alpha, dropped = (
        torch.stack([o[k] for o in outs]).reshape(b, v, *outs[0][k].shape)
        for k in range(4)
    )
    return DecoderOutput(color=color, depth=depth, alpha=alpha, dropped=dropped)


def make_decoder(
    cfg: DecoderCfg, device: str | torch.device = "cuda"
) -> Callable[..., DecoderOutput]:
    """``render_views`` bound to ``cfg``, checking that the Gaussians lie on
    ``device`` (default the GPU; raises without one)."""
    device = resolve_device(device)

    def decode(gaussians: Gaussians, extrinsics, intrinsics, near, far, image_shape):
        if gaussians.means.device.type != device.type:
            raise ValueError(
                f"decoder on {device} got Gaussians on {gaussians.means.device}"
            )
        return render_views(cfg, gaussians, extrinsics, intrinsics, near, far, image_shape)

    return decode
