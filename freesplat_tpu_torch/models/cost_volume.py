"""Plane-sweep cost volume.

Port of ``freesplat_tpu/models/cost_volume.py``: ``similarity="avg_mlp"``
(the average warped feature and the view-averaged dot product through a
per-(pixel, plane) MLP head; FreeSplat's runtime path) and ``"cosine"``
(the view-averaged masked cosine similarity, no MLP; a module option that
no config reaches).  The JAX ``nn.vmap`` over scenes becomes one batch
dimension (every view of every scene), and the ``lax.map`` over plane
chunks a loop; chunking is numerically neutral.  ``dtype`` is the MLP
head's compute dtype (flax's ``dtype``); the volume is returned in
float32.

Where no gradient can flow, on CUDA float32 tensors with a float32 head
the kernel was built for (``kernel_takes``), one kernel computes the
``avg_mlp`` volume (``ops/plane_sweep.py``) and the loop is skipped; the
loop is the path of the CPU, of autograd and of every other case.  Each
call counts its samples (views x sources x planes x pixels) as
``plane_sweep_samples`` with ``path`` "fused" or "plain".
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import plane_sweep as PS
from ..ops.grid_sample import bilinear_sample
from ..utils.profiling import count
from .layers import MLP, cast_at_use

SIMILARITIES = ("avg_mlp", "cosine")


def inverse_depth_planes(
    num_planes: int, min_depth: torch.Tensor, max_depth: torch.Tensor
) -> torch.Tensor:
    """(..., D) plane depths, linear in inverse depth from min to max."""
    t = torch.linspace(0.0, 1.0, num_planes, device=min_depth.device)
    min_depth = min_depth[..., None]
    max_depth = max_depth[..., None]
    inv = 1.0 / min_depth + (1.0 / max_depth - 1.0 / min_depth) * t
    return 1.0 / inv


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class CostVolume(nn.Module):
    """NHWC at matching resolution (input / 4).

    forward(cur_feats (B, h, w, c), src_feats (B, s, h, w, c), src_T_cur
    (B, s, 4, 4) current-cam -> source-cam, src_K (B, s, 4, 4) source pixel
    intrinsics, cur_invK (B, 4, 4), min/max_depth (B,)) -> (B, h, w, D)
    float32.
    """

    # Rows (B * s * planes * pixels) sampled per chunk: ~1.5 GB of warped
    # features at c = 48, well inside an 80 GB card.
    budget_rows = 8_000_000

    def __init__(self, feat_ch: int, num_depth_bins: int = 64,
                 mlp_channels=(32, 32, 1), dtype: torch.dtype | None = None,
                 similarity: str = "avg_mlp"):
        super().__init__()
        if similarity not in SIMILARITIES:
            raise ValueError(f"similarity must be one of {SIMILARITIES}, got {similarity!r}")
        self.num_depth_bins = num_depth_bins
        self.similarity = similarity
        if similarity == "avg_mlp":
            self.mlp = cast_at_use(
                MLP(feat_ch + 1, mlp_channels, disable_final_activation=True), dtype)

    def kernel_takes(self, *tensors: torch.Tensor) -> bool:
        """Whether ``ops/plane_sweep.py``'s kernel computes a call on these
        inputs, their device aside: ``avg_mlp`` with a float32 head of the
        kernel's widths, float32 inputs, features of a width it was built
        for, and no gradient to carry (none enabled, or nothing requiring
        one)."""
        if self.similarity != "avg_mlp":
            return False
        c = tensors[0].shape[-1]
        params = list(self.mlp.parameters())
        return (PS.head_widths(self.mlp) == (c + 1, *PS.HIDDEN) and c in PS.CHANNELS
                and 1 <= tensors[1].shape[1] <= PS.MAX_SOURCES
                and all(t.dtype == torch.float32 for t in tensors)
                and not (torch.is_grad_enabled()
                         and any(t.requires_grad for t in (*tensors, *params))))

    def forward(self, cur_feats, src_feats, src_T_cur, src_K, cur_invK,
                min_depth, max_depth, eps: float = 1e-8):
        b, h, w, c = cur_feats.shape
        v = src_feats.shape[1]
        d = self.num_depth_bins
        n = h * w
        dev = cur_feats.device
        args = (cur_feats, src_feats, src_T_cur, src_K, cur_invK, min_depth, max_depth)
        fused = cur_feats.is_cuda and self.kernel_takes(*args)
        count("plane_sweep_samples", b * v * d * n, path="fused" if fused else "plain")
        cosine = self.similarity == "cosine"
        plane_chunk = max(1, min(d, self.budget_rows // max(b * v * n, 1)))
        depths = inverse_depth_planes(d, min_depth, max_depth)  # (b, d)

        # Pixel rays through half-integer centers.
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij",
        )
        pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
        rays = torch.einsum("bij,nj->bni", cur_invK[:, :3, :3], pix)  # (b, n, 3)
        proj = torch.einsum("bvij,bvjk->bvik", src_K, src_T_cur)[:, :, :3]
        if fused:
            return PS.plane_sweep(cur_feats, src_feats, depths, rays, proj,
                                  PS.pack_head(self.mlp))
        src_flat = src_feats.reshape(b * v, h, w, c)
        if cosine:
            # The warp is linear: warped vectors are renormalized after it.
            cur_feats = _unit(cur_feats)
        cur = cur_feats.reshape(b, 1, 1, n, c)

        chunks = []
        for s in range(0, d, plane_chunk):
            depth_chunk = depths[:, s:s + plane_chunk]  # (b, dc)
            dc = depth_chunk.shape[1]
            cam = rays[:, None] * depth_chunk[:, :, None, None]  # (b, dc, n, 3)
            cam_h = torch.cat([cam, torch.ones_like(cam[..., :1])], dim=-1)
            p = torch.einsum("bvij,bdnj->bvdni", proj, cam_h)  # (b, v, dc, n, 3)
            z = p[..., 2:3]
            scale = torch.where(z.abs() > eps, 1.0 / (z + eps), 1.0)
            uv = (p[..., :2] * scale).detach()  # geometry only: no gradient
            warped = bilinear_sample(
                src_flat, uv.reshape(b * v, dc * n, 2)
            ).reshape(b, v, dc, n, c)
            mask = (z > 0).to(warped.dtype)
            if cosine:
                warped = _unit(warped)
            dot = (warped * cur).sum(-1) * mask[..., 0]  # (b, v, dc, n)
            nonzero = (dot != 0).to(warped.dtype)
            denom = nonzero.sum(1) + 1e-8  # (b, dc, n)
            dot_avg = dot.sum(1) / denom
            if cosine:
                chunks.append(dot_avg)  # (b, dc, n)
                continue
            feat_avg = (warped * nonzero[..., None]).sum(1) / denom[..., None]
            combined = torch.cat([feat_avg, dot_avg[..., None]], dim=-1)
            chunks.append(self.mlp(combined)[..., 0])  # (b, dc, n)
        volume = torch.cat(chunks, dim=1)  # (b, d, n)
        return volume.transpose(1, 2).reshape(b, h, w, d).float()
