"""The explicit whole-scene multi-device pipeline: view-sharded trunk ->
sharded PTF -> Gaussian head, and rendering with the Gaussians sharded.

Port of ``freesplat_tpu/parallel/whole_scene.py``.  The pieces are the
hand-written collectives: the trunk runs view-sharded (each rank its own
views, the matching features and trunk outputs all-gathered:
``evaluation/harness.py::make_chunked_encode`` with a group), PTF with
the slot buffer sharded (``sharded_ptf``: two minima and one sum a view),
the head replicated; the target views render with the Gaussians split
over the ranks and each rank compositing a slab of tile columns
(``sharded_render``).  One scene (b = 1); the ranks must divide the
views.
"""
from __future__ import annotations

import time
from typing import Any

import torch

from ..evaluation.harness import make_chunked_encode
from ..models.decoder import DecoderCfg
from ..models.encoder import EncoderFreeSplat
from ..models.types import Gaussians
from ..ops.rasterizer import render_capacity
from .distributed import group_rank
from .sharded_ptf import fuse_views_sharded
from .sharded_render import rasterize_sharded


def encode_whole_scene(
    encoder: EncoderFreeSplat,
    context: dict[str, torch.Tensor],
    group=None,
    view_chunk: int | None = None,
    timings: dict[str, list[float]] | None = None,
) -> dict[str, Any]:
    """``encoder(context)``'s results (without the lower scales' depths)
    with every stage split over the ranks of ``group``: the trunk
    view-sharded (chunks of ``view_chunk`` of a rank's views, default one
    chunk), PTF with the buffer sharded, the head replicated.
    ``timings`` as ``make_chunked_encode``'s, plus "C1_ptf_s" and
    "C2_head_s" of this pipeline."""
    images = context["image"]
    b, v, h, w, _ = images.shape
    if b != 1:
        raise ValueError(f"the whole-scene pipeline takes one scene, got {b}")
    trunk = make_chunked_encode(encoder, view_chunk, timings, group=group, trunk_only=True)(
        context)
    sync = torch.cuda.synchronize if images.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    state = fuse_views_sharded(
        trunk["feat_v"][0], trunk["coords_v"][0], trunk["dens_v"][0], trunk["wt_v"][0],
        trunk["depth_v"][0], context["extrinsics"][0], context["intrinsics"][0], (h, w),
        encoder.fuse.gru, group=group,
    )
    sync()
    t1 = time.perf_counter()
    g, scales, rotations = encoder.fuse.head(state, context["intrinsics"][0, 0], (h, w))
    sync()
    if timings is not None:
        timings.setdefault("C1_ptf_s", []).append(t1 - t0)
        timings.setdefault("C2_head_s", []).append(
            time.perf_counter() - t1)
    gaussians = Gaussians(*(x[None] for x in g))
    num_valid = gaussians.mask.sum(-1)
    return {
        "gaussians": gaussians,
        "num_gaussians": num_valid,
        "gs_ratio": num_valid / (v * h * w),
        "depth_s-1": trunk["depth_s-1"],
        "densities": trunk["densities"],
        "depth_weights": trunk["depth_weights"],
        "visualizations": {"scales": scales[None], "rotations": rotations[None]},
    }


def render_whole_scene(
    cfg: DecoderCfg,
    gaussians: Gaussians,  # (g, ...) or batched with b = 1
    extrinsics: torch.Tensor,  # (v, 4, 4)
    intrinsics: torch.Tensor,  # (v, 3, 3)
    near: torch.Tensor,  # (v,)
    far: torch.Tensor,  # (v,)
    image_shape: tuple[int, int],
    group=None,
):
    """Render the target views with the Gaussians split over the ranks of
    ``group`` (each rank takes its equal share of every rank's copy) and
    the tile columns too (``rasterize_sharded``), with
    ``models/decoder.py::render_view``'s semantics: the 1/near rescale,
    the background, masked opacities, ``cfg.depth_mode``.  The budget is
    ``render_capacity(g, cfg.capacity_factor)`` of the whole set.  Returns
    (color (v, h, w, 3), depth (v, h, w), alpha (v, h, w), dropped (v,))."""
    if gaussians.means.dim() == 3:
        gaussians = Gaussians(*(x[0] if x is not None else None for x in gaussians))
    rank, world = group_rank(group)
    n = gaussians.means.shape[0]
    if n % world:
        raise ValueError(f"{n} Gaussians do not split over {world} ranks")
    mine = slice(rank * (n // world), (rank + 1) * (n // world))
    means = gaussians.means[mine]
    covs = gaussians.covariances[mine]
    harm = gaussians.harmonics[mine]
    opac = gaussians.masked_opacities()[mine]
    background = torch.tensor(cfg.background_color, dtype=torch.float32, device=means.device)
    capacity = render_capacity(n, cfg.capacity_factor)
    outs = []
    for vi in range(extrinsics.shape[0]):
        e, m, c = extrinsics[vi], means, covs
        if cfg.scale_invariant:
            s = 1.0 / near[vi]
            e = e.clone()
            e[:3, 3] = e[:3, 3] * s
            m = m * s
            c = c * (s * s)
        color, depth_acc, alpha, stats = rasterize_sharded(
            m, c, harm, opac, e, intrinsics[vi], image_shape, background, cfg.sh_degree,
            group=group, capacity=capacity, return_stats=True,
        )
        if cfg.scale_invariant:
            depth_acc = depth_acc * near[vi]
        outs.append((color, depth_acc, alpha, stats["dropped"]))
    color, depth_acc, alpha, dropped = (torch.stack(x) for x in zip(*outs))
    if cfg.depth_mode == "ref_compat":
        depth = depth_acc / 2.0
    elif cfg.depth_mode == "depth":
        depth = depth_acc / torch.clamp(alpha, min=1e-6)
    else:
        depth = depth_acc
    return color, depth, alpha, dropped
