"""Pixel-wise Triplet Fusion (PTF) over a fixed slot buffer.

Port of ``freesplat_tpu/models/ptf.py::fuse_views``: the global Gaussian
set lives in V*H*W slots with a validity mask (view i owns slots
[i*HW, (i+1)*HW)).  Per new view: project every valid slot, z-buffer to
one winner per pixel, merge the pixels whose predicted depth agrees with
the z-buffer (|dz| < max(5% d, 0.1)) through the GRU and density-weighted
averages, and let unmatched pixels claim their own slots.

Winner rule.  Slots that tie exactly on z at one pixel all qualify; the
JAX scatter leaves their order undefined (on the CPU the last write, the
largest slot, wins).  Here the largest slot index wins, always:
``scatter_reduce(..., "amax")`` over the qualifying slot ids.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .networks import positional_encoding


class PTFState(NamedTuple):
    """Global Gaussian buffer; G = num_views * H * W slots."""

    feat: torch.Tensor  # (G, C)
    coords: torch.Tensor  # (G, 3)
    density: torch.Tensor  # (G, 1)
    weight: torch.Tensor  # (G, 1)
    depth: torch.Tensor  # (G,)
    extrinsics: torch.Tensor  # (G, 4, 4)
    valid: torch.Tensor  # (G,) bool


def _project_to_view(coords, extrinsic, intrinsic, image_shape):
    """Returns (pixel_index (G,), depth (G,), in_bounds (G,))."""
    h, w = image_shape
    w2c = torch.linalg.inv(extrinsic)
    cam = coords @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    fx, fy = intrinsic[0, 0] * w, intrinsic[1, 1] * h
    cx, cy = intrinsic[0, 2] * w, intrinsic[1, 2] * h
    u = cam[:, 0] / z * fx + cx
    v = cam[:, 1] / z * fy + cy
    # Round half to even, as jnp.round; nan/inf land out of bounds.
    ui = torch.nan_to_num(torch.round(u), nan=-1.0, posinf=-1.0, neginf=-1.0)
    vi = torch.nan_to_num(torch.round(v), nan=-1.0, posinf=-1.0, neginf=-1.0)
    in_bounds = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (z > 0)
    pix = torch.where(in_bounds, vi.long() * w + ui.long(), h * w)
    return pix, z, in_bounds


def _pack(feat, density, weight, coords, depth, extr16):
    return torch.cat([feat, density, weight, coords, depth[:, None], extr16], dim=-1)


def fuse_views(
    feats: torch.Tensor,  # (V, HW, C)
    coords: torch.Tensor,  # (V, HW, 3)
    densities: torch.Tensor,  # (V, HW, 1)
    weights: torch.Tensor,  # (V, HW, 1)
    depths: torch.Tensor,  # (V, HW)
    extrinsics: torch.Tensor,  # (V, 4, 4)
    intrinsics: torch.Tensor,  # (V, 3, 3) normalized
    image_shape: tuple[int, int],
    gru_apply: Callable[..., torch.Tensor],
    depth_thres: float = 0.1,
    pe_freqs: int = 6,
) -> PTFState:
    """Run PTF over all views; returns the fused global buffer.

    Packed buffer columns: [feat c | density | weight | coords 3 | depth |
    extrinsics 16]."""
    v, hw, c = feats.shape
    g = v * hw
    packed = feats.new_zeros((g, c + 22))
    packed[:hw] = _pack(feats[0], densities[0], weights[0], coords[0], depths[0],
                        extrinsics[0].reshape(1, 16).expand(hw, 16))
    valid = torch.zeros(g, dtype=torch.bool, device=feats.device)
    valid[:hw] = True
    for i in range(1, v):
        packed, valid = _fuse_one_view(
            packed, valid, c, i, hw, feats[i], coords[i], densities[i],
            weights[i], depths[i], extrinsics[i], intrinsics[i], image_shape,
            gru_apply, depth_thres, pe_freqs,
        )
    return PTFState(
        feat=packed[:, :c],
        density=packed[:, c : c + 1],
        weight=packed[:, c + 1 : c + 2],
        coords=packed[:, c + 2 : c + 5],
        depth=packed[:, c + 5],
        extrinsics=packed[:, c + 6 : c + 22].reshape(g, 4, 4),
        valid=valid,
    )


def _fuse_one_view(
    packed, valid, c, i, hw, feat_i, coords_i, density_i, weight_i, depth_i,
    extrinsic_i, intrinsic_i, image_shape, gru_apply, depth_thres, pe_freqs,
):
    g = packed.shape[0]
    dev = packed.device
    pix, z, in_bounds = _project_to_view(
        packed[:, c + 2 : c + 5], extrinsic_i, intrinsic_i, image_shape
    )
    proj_ok = in_bounds & valid
    seg = torch.where(proj_ok, pix, hw)

    # Z-buffer: nearest projecting slot per pixel.
    zmin = torch.full((hw + 1,), torch.inf, device=dev).scatter_reduce(
        0, seg, torch.where(proj_ok, z, torch.inf), "amin"
    )[:hw]

    # Winner per pixel: the largest slot id among exact-z ties.
    is_winner = proj_ok & (z == zmin[torch.clamp(pix, 0, hw - 1)])
    winner = torch.full((hw + 1,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, torch.where(is_winner, pix, hw), torch.arange(g, device=dev), "amax"
    )[:hw]
    has_winner = winner >= 0

    # Depth-consistency match (|zbuf - pred| < max(5% pred, thres)).
    zbuf = torch.where(torch.isfinite(zmin), zmin, 1e4)
    fusion_mask = (zbuf - depth_i).abs() < torch.clamp(depth_i * 0.05, min=depth_thres)
    matched = fusion_mask & has_winner

    gathered = packed[torch.where(matched, winner, 0)]
    g_feat = gathered[:, :c]
    g_density = gathered[:, c : c + 1]
    g_weight = gathered[:, c + 1 : c + 2]
    g_coords = gathered[:, c + 2 : c + 5]
    g_depth = gathered[:, c + 5]
    g_extr = gathered[:, c + 6 : c + 22].reshape(-1, 4, 4)

    # GRU latent fusion: input = view pixel feature, hidden = global one.
    in_emb = positional_encoding(torch.cat([g_density, weight_i], dim=-1), pe_freqs)
    hid_emb = positional_encoding(torch.cat([density_i, g_weight], dim=-1), pe_freqs)
    fused_feat = gru_apply(feat_i, g_feat, in_emb, hid_emb)

    w0 = g_density
    w1 = density_i
    denom = w0 + w1
    fused = _pack(
        fused_feat,
        g_density + density_i,
        g_weight + weight_i,
        (g_coords * w0 + coords_i * w1) / denom,
        (g_depth * w0[:, 0] + depth_i * w1[:, 0]) / denom[:, 0],
        ((g_extr * w0[..., None] + extrinsic_i[None] * w1[..., None])
         / denom[..., None]).reshape(-1, 16),
    )
    # Matched pixels overwrite their winning slot (winners are distinct).
    packed = packed.clone()
    packed[winner[matched]] = fused[matched]

    # Unmerged pixels of view i claim their own slots.
    new = ~fusion_mask
    own = _pack(feat_i, density_i, weight_i, coords_i, depth_i,
                extrinsic_i.reshape(1, 16).expand(hw, 16))
    packed[i * hw : (i + 1) * hw] = torch.where(new[:, None], own, 0.0)
    valid = valid.clone()
    valid[i * hw : (i + 1) * hw] = new
    return packed, valid
