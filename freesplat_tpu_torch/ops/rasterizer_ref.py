"""Dense reference rasterizer: per-pixel full evaluation (no tiling).

Port of ``freesplat_tpu/ops/rasterizer_ref.py``.  O(N * H * W) memory, but
exact and differentiable: the golden model for the tile rasterizer.  Keeps
the CUDA rasterizer's semantics: 1/255 alpha cut, 0.99 clamp, and the
T < 1e-4 early termination (which also affects the background term).
"""
from __future__ import annotations

import torch

from .rendering import (
    ALPHA_MAX,
    ALPHA_MIN,
    Screen,
    TILE,
    TRANSMITTANCE_EPS,
    preprocess_gaussians,
)


def composite_reference(
    screen: Screen,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (3,)
    tile_cull: int | None = TILE,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (color (h, w, 3), unnormalized depth (h, w), alpha (h, w))."""
    h, w = image_shape
    dev, dt = screen.means2d.device, screen.means2d.dtype

    # Front to back; culled Gaussians go last.
    order = torch.argsort(
        torch.where(screen.mask, screen.depths, torch.inf), stable=True
    )
    mean2d = screen.means2d[order]
    conic = screen.conics[order]
    color = screen.colors[order]
    opac = screen.opacities[order]
    depth = screen.depths[order]
    mask = screen.mask[order]

    py, px = torch.meshgrid(
        torch.arange(h, dtype=dt, device=dev),
        torch.arange(w, dtype=dt, device=dev),
        indexing="ij",
    )  # (h, w)
    dx = px[None] - mean2d[:, 0, None, None]  # (n, h, w)
    dy = py[None] - mean2d[:, 1, None, None]
    power = -0.5 * (
        conic[:, 0, None, None] * dx * dx + conic[:, 2, None, None] * dy * dy
    ) - conic[:, 1, None, None] * dx * dy
    alpha = torch.clamp(opac[:, None, None] * torch.exp(power), max=ALPHA_MAX)
    alpha = torch.where(power > 0.0, 0.0, alpha)
    skip = (alpha < ALPHA_MIN) | ~mask[:, None, None]

    if tile_cull is not None:
        # A Gaussian only touches pixels whose tile lies inside its radius rect.
        radius = screen.radii[order]
        tw = -(-w // tile_cull)
        th = -(-h // tile_cull)
        gx0 = torch.clamp(torch.floor((mean2d[:, 0] - radius) / tile_cull), 0, tw)
        gy0 = torch.clamp(torch.floor((mean2d[:, 1] - radius) / tile_cull), 0, th)
        gx1 = torch.clamp(
            torch.floor((mean2d[:, 0] + radius + tile_cull - 1) / tile_cull), 0, tw
        )
        gy1 = torch.clamp(
            torch.floor((mean2d[:, 1] + radius + tile_cull - 1) / tile_cull), 0, th
        )
        ptx = torch.floor(px / tile_cull)
        pty = torch.floor(py / tile_cull)
        inside = (
            (ptx[None] >= gx0[:, None, None])
            & (ptx[None] < gx1[:, None, None])
            & (pty[None] >= gy0[:, None, None])
            & (pty[None] < gy1[:, None, None])
        )
        skip = skip | ~inside
    eff_alpha = torch.where(skip, 0.0, alpha)

    # Exclusive running transmittance T_g = prod_{j<g} (1 - a_j).
    log_one_minus = torch.log1p(-eff_alpha)
    log_t = torch.cat(
        [torch.zeros_like(log_one_minus[:1]), torch.cumsum(log_one_minus, 0)[:-1]],
        dim=0,
    )
    t_excl = torch.exp(log_t)

    # A Gaussian whose blend would push T below 1e-4 is skipped and stops
    # the pixel.
    test = torch.where(skip, torch.inf, t_excl * (1.0 - eff_alpha))
    alive = torch.cumprod((test >= TRANSMITTANCE_EPS).to(dt), dim=0)

    weight = eff_alpha * t_excl * alive  # (n, h, w)
    out_color = torch.einsum("nhw,nc->hwc", weight, color)
    out_depth = torch.einsum("nhw,n->hw", weight, depth)
    t_final = torch.exp(torch.log1p(-eff_alpha * alive).sum(0))
    out_color = out_color + t_final[..., None] * background
    return out_color, out_depth, 1.0 - t_final


def render_reference(
    means, covariances, harmonics, opacities, extrinsics, intrinsics,
    image_shape: tuple[int, int], background: torch.Tensor, sh_degree: int,
    tile_cull: int | None = TILE,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render one view. Returns (color (h, w, 3), depth (h, w), alpha (h, w))."""
    screen = preprocess_gaussians(
        means, covariances, harmonics, opacities, extrinsics, intrinsics,
        image_shape, sh_degree,
    )
    return composite_reference(screen, image_shape, background, tile_cull=tile_cull)
