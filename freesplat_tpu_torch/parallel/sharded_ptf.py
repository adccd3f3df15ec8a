"""Sharded Pixel-wise Triplet Fusion: the global Gaussian slot buffer
split over the ranks of a process group.

Port of ``freesplat_tpu/parallel/sharded_ptf.py``.  Each rank owns the
slot blocks of ``views_per_rank`` views (``g_local = views_per_rank * HW``
slots).  Fusing view i is sequential, but all per-slot work is local:

1. every rank projects its slots into view i and z-buffers them;
2. an ``all_reduce(MIN)`` merges the per-pixel z-buffers, and a second
   one over the ranks' ids gives each pixel to the lowest rank that holds
   a slot at the global minimum;
3. one ``all_reduce(SUM)`` of an (HW, C + 22) contribution (zeros on the
   other ranks) brings the winning rows to every rank;
4. the GRU fuse runs replicated, and each rank writes the fused rows
   into its own winning slots;
5. view i's owner rank lets its unmatched pixels claim its block.

Per view: O(g_local) local work, two (HW,) minima and one (HW, C + 22)
sum; the buffer never moves until the final all-gather.  The result is
``models/ptf.py::fuse_views``'s but for the winner among slots that tie
exactly on z: here the largest slot of the lowest rank holding one,
there the largest slot (both within the reference's nondeterministic
scatter).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.networks import positional_encoding
from ..models.ptf import PTFState, _pack, _project_to_view
from .distributed import (
    all_gather_plain, all_reduce_min, gather_replicated, group_rank, sum_replicated,
)


def fuse_views_sharded(
    feats: torch.Tensor,  # (V, HW, C), the same on every rank
    coords: torch.Tensor,  # (V, HW, 3)
    densities: torch.Tensor,  # (V, HW, 1)
    weights: torch.Tensor,  # (V, HW, 1)
    depths: torch.Tensor,  # (V, HW)
    extrinsics: torch.Tensor,  # (V, 4, 4)
    intrinsics: torch.Tensor,  # (V, 3, 3) normalized
    image_shape: tuple[int, int],
    gru_apply: Callable[..., torch.Tensor],
    group=None,
    depth_thres: float = 0.1,
    pe_freqs: int = 6,
) -> PTFState:
    """PTF with the slot buffer split over the ranks of ``group`` (None:
    one process); returns the whole fused buffer on every rank, in
    ``fuse_views``' layout.  The ranks must divide V."""
    v, hw, c = feats.shape
    rank, world = group_rank(group)
    if v % world:
        raise ValueError(f"{v} views do not split over {world} ranks")
    vpr = v // world
    g_local = vpr * hw
    dev = feats.device
    inplace = not torch.is_grad_enabled() or not any(
        t.requires_grad for t in (feats, coords, densities, weights, depths))

    def own_rows(i):
        return _pack(feats[i], densities[i], weights[i], coords[i], depths[i],
                     extrinsics[i].reshape(1, 16).expand(hw, 16))

    packed = feats.new_zeros((g_local, c + 22))
    valid = torch.zeros(g_local, dtype=torch.bool, device=dev)
    if rank == 0:  # view 0 seeds the buffer in its owner's first block
        packed[:hw] = own_rows(0)
        valid[:hw] = True
    slot = torch.arange(g_local, device=dev)
    spread = slot % hw
    for i in range(1, v):
        pix, z, in_bounds = _project_to_view(packed[:, c + 2:c + 5], extrinsics[i],
                                             intrinsics[i], image_shape)
        proj_ok = in_bounds & valid
        # Local z-buffer (projecting z > 0: its bits order as int32), then
        # the global one.
        zbits = torch.where(proj_ok, z, torch.inf).view(torch.int32)
        zmin_l = torch.full((hw,), torch.inf, device=dev).view(torch.int32).scatter_reduce(
            0, torch.where(proj_ok, pix, spread), zbits, "amin").view(torch.float32)
        zmin = all_reduce_min(zmin_l, group)

        # Local winner among the slots at the global minimum (the largest
        # slot), then the lowest rank that has one.
        is_winner = proj_ok & (z == zmin[torch.clamp(pix, 0, hw - 1)])
        winner = torch.full((hw,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, torch.where(is_winner, pix, spread), torch.where(is_winner, slot, -1), "amax")
        has_local = winner >= 0
        rank_win = all_reduce_min(
            torch.where(has_local, rank, world).to(torch.int32), group)

        zbuf = torch.where(torch.isfinite(zmin), zmin, 1e4)
        fusion_mask = (zbuf - depths[i]).abs() < torch.clamp(depths[i] * 0.05, min=depth_thres)
        matched = fusion_mask & (rank_win < world)
        mine = matched & has_local & (rank_win == rank)

        # The winning rows on every rank: one sum of the owners' rows.
        contrib = torch.where(mine[:, None], packed.index_select(0, torch.where(mine, winner, 0)),
                              0.0)
        gathered = sum_replicated(contrib, group)
        g_feat = gathered[:, :c]
        g_density = gathered[:, c:c + 1]
        g_weight = gathered[:, c + 1:c + 2]
        g_coords = gathered[:, c + 2:c + 5]
        g_depth = gathered[:, c + 5]
        g_extr = gathered[:, c + 6:c + 22].reshape(-1, 4, 4)

        in_emb = positional_encoding(torch.cat([g_density, weights[i]], dim=-1), pe_freqs)
        hid_emb = positional_encoding(torch.cat([densities[i], g_weight], dim=-1), pe_freqs)
        fused_feat = gru_apply(feats[i], g_feat, in_emb, hid_emb)
        w0, w1 = g_density, densities[i]
        denom = w0 + w1
        fused = _pack(
            fused_feat,
            g_density + densities[i],
            g_weight + weights[i],
            (g_coords * w0 + coords[i] * w1) / denom,
            (g_depth * w0[:, 0] + depths[i] * w1[:, 0]) / denom[:, 0],
            ((g_extr * w0[..., None] + extrinsics[i][None] * w1[..., None])
             / denom[..., None]).reshape(-1, 16),
        )
        if not inplace:
            packed, valid = packed.clone(), valid.clone()
        packed[winner[mine]] = fused[mine]

        # Unmatched pixels of view i claim its block, on its owner.
        if i // vpr == rank:
            block = slice((i - rank * vpr) * hw, (i - rank * vpr + 1) * hw)
            new = ~fusion_mask
            packed[block] = torch.where(new[:, None], own_rows(i), 0.0)
            valid[block] = new

    packed = gather_replicated(packed, group)
    valid = all_gather_plain(valid, group)
    return PTFState(
        feat=packed[:, :c],
        density=packed[:, c:c + 1],
        weight=packed[:, c + 1:c + 2],
        coords=packed[:, c + 2:c + 5],
        depth=packed[:, c + 5],
        extrinsics=packed[:, c + 6:c + 22].reshape(-1, 4, 4),
        valid=valid,
    )
