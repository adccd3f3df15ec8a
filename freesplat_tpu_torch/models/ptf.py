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

View i projects, z-buffers and scatters over the live prefix
[0, (i+1)*HW) of the buffer only: no later slot is valid yet, so invalid
tail slots would never project, win or be scattered into (the JAX
package's bucketed path grows its buffer for the same reason, in
buckets because XLA needs static shapes).  Without a gradient the buffer
is updated in place; with one, each view works on a copy, as autograd
needs, and a merge weighs its two densities each raised by
``DENSITY_FLOOR``, which keeps its average and gradient finite where
densities round to 0 (``_fuse_one_view``).

While a recorder is active (``utils/profiling.py``), the backward pass
through the fusion is the span ``encoder.ptf.backward``, each view's
merged pixels are the counter ``ptf_merged`` (a device tensor, read at
the recorder's flush), and the bytes those copies write (the live
prefix's clone and the tail's concatenation, with the validity mask) are
``ptf_copy_bytes`` (from the shapes, on the host).

The gather of the winning slots is ``index_select``, not
``ops/gather.py::take_rows``: unmatched pixels read slot 0, but their rows
reach nothing (only ``fused[matched]`` is written back), so their
gradient is exactly zero, and matched pixels read distinct slots (a slot
projects to one pixel).  ``index_add_``'s atomics then add zeros to one
non-zero term at most, which gives the same sum in any order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.profiling import active, backward_span, count, synced_inside
from .networks import positional_encoding


# Added to each density a merge averages by under autograd, so that the
# average's backward stays finite; see ``_fuse_one_view``.
DENSITY_FLOOR = 1e-18


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
    synced_inside("ptf.project_to_view")
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
    inplace = not torch.is_grad_enabled() or not any(
        t.requires_grad for t in (feats, coords, densities, weights, depths))
    packed = feats.new_zeros((g, c + 22))
    packed[:hw] = _pack(feats[0], densities[0], weights[0], coords[0], depths[0],
                        extrinsics[0].reshape(1, 16).expand(hw, 16))
    valid = torch.zeros(g, dtype=torch.bool, device=feats.device)
    valid[:hw] = True
    recorded = active() is not None
    row_bytes = (c + 22) * packed.element_size() + valid.element_size()
    copied = 0
    for i in range(1, v):
        live = (i + 1) * hw
        p, vd = _fuse_one_view(
            packed[:live], valid[:live], c, i, hw, feats[i], coords[i], densities[i],
            weights[i], depths[i], extrinsics[i], intrinsics[i], image_shape,
            gru_apply, depth_thres, pe_freqs, inplace,
        )
        if not inplace:  # copies: keep the buffer's tail beyond the prefix
            packed = p if live == g else torch.cat([p, packed[live:]])
            valid = vd if live == g else torch.cat([vd, valid[live:]])
            copied += (live + (g if live != g else 0)) * row_bytes
    if recorded and not inplace:
        count("ptf_copy_bytes", copied)
        backward_span("encoder.ptf.backward", [packed],
                      [feats, coords, densities, weights, depths])
    return PTFState(
        feat=packed[:, :c],
        density=packed[:, c : c + 1],
        weight=packed[:, c + 1 : c + 2],
        coords=packed[:, c + 2 : c + 5],
        depth=packed[:, c + 5],
        extrinsics=packed[:, c + 6 : c + 22].reshape(g, 4, 4),
        valid=valid,
    )


def fuse_views_bucketed(
    feats: torch.Tensor,
    coords: torch.Tensor,
    densities: torch.Tensor,
    weights: torch.Tensor,
    depths: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    image_shape: tuple[int, int],
    gru_apply: Callable[..., torch.Tensor],
    depth_thres: float = 0.1,
    pe_freqs: int = 6,
    buckets: tuple[int, ...] | None = None,
) -> PTFState:
    """``fuse_views``, under the JAX package's name for its whole-scene
    path: ``fuse_views`` already works on the live prefix of the buffer
    (see the module docstring), which is what the JAX path's buckets
    approximate.  ``buckets`` (its static buffer sizes) is accepted for
    its callers and has no effect."""
    del buckets
    return fuse_views(feats, coords, densities, weights, depths, extrinsics, intrinsics,
                      image_shape, gru_apply, depth_thres, pe_freqs)


def _fuse_one_view(
    packed, valid, c, i, hw, feat_i, coords_i, density_i, weight_i, depth_i,
    extrinsic_i, intrinsic_i, image_shape, gru_apply, depth_thres, pe_freqs, inplace,
):
    g = packed.shape[0]
    dev = packed.device
    pix, z, in_bounds = _project_to_view(
        packed[:, c + 2 : c + 5], extrinsic_i, intrinsic_i, image_shape
    )
    proj_ok = in_bounds & valid
    slot = torch.arange(g, device=dev)
    # Slots that do not project scatter a value that cannot win (inf, -1)
    # to a pixel of their own: one shared sentinel address would serialize
    # the atomics of millions of slots on the GPU.
    spread = slot % hw

    # Z-buffer: nearest projecting slot per pixel.  Projecting z > 0, so
    # its float32 bits order as int32 and the min is an integer atomic.
    zbits = torch.where(proj_ok, z, torch.inf).view(torch.int32)
    zmin = torch.full((hw,), torch.inf, device=dev).view(torch.int32).scatter_reduce(
        0, torch.where(proj_ok, pix, spread), zbits, "amin"
    ).view(torch.float32)

    # Winner per pixel: the largest slot id among exact-z ties.
    is_winner = proj_ok & (z == zmin[torch.clamp(pix, 0, hw - 1)])
    winner = torch.full((hw,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, torch.where(is_winner, pix, spread), torch.where(is_winner, slot, -1), "amax"
    )
    has_winner = winner >= 0

    # Depth-consistency match (|zbuf - pred| < max(5% pred, thres)).
    zbuf = torch.where(torch.isfinite(zmin), zmin, 1e4)
    fusion_mask = (zbuf - depth_i).abs() < torch.clamp(depth_i * 0.05, min=depth_thres)
    matched = fusion_mask & has_winner
    if active() is not None:
        count("ptf_merged", matched.sum(), view=i)

    gathered = packed.index_select(0, torch.where(matched, winner, 0))
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
    if not inplace:
        # Densities are sigmoids: under a logit of -104 they are 0, and the
        # average 0 / 0 is a NaN Gaussian that the renderer culls but whose
        # gradient (0 times NaN) makes every gradient NaN; over a subnormal
        # sum the division's backward overflows.  DENSITY_FLOOR added
        # to each weight leaves every density of 3e-11 or more as it is (it
        # is under half its rounding step) and turns the weights of two
        # lesser ones smoothly towards equal: a threshold would flip whole
        # regions of like densities together on a rounding difference.
        w0, w1 = w0 + DENSITY_FLOOR, w1 + DENSITY_FLOOR
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
    if not inplace:
        packed, valid = packed.clone(), valid.clone()
    packed[winner[matched]] = fused[matched]
    synced_inside("ptf.fuse_one_view", 2)

    # Unmerged pixels of view i claim their own slots.
    new = ~fusion_mask
    own = _pack(feat_i, density_i, weight_i, coords_i, depth_i,
                extrinsic_i.reshape(1, 16).expand(hw, 16))
    packed[i * hw : (i + 1) * hw] = torch.where(new[:, None], own, 0.0)
    valid[i * hw : (i + 1) * hw] = new
    return packed, valid
