"""Multi-device rasterization: Gaussians sharded over the ranks, the image
over tile-column slabs.

Port of ``freesplat_tpu/parallel/sharded_render.py``.  Each rank holds a
shard of the Gaussians and preprocesses it; the screen-space parameters
(the compositor's ten columns, the radius and the mask) are all-gathered,
each rank bins and composites only its own slab of ``tiles_x / world``
tile columns (``render_slab``: the CUDA kernels at
``col_offset = rank * local_cols``), and the slabs are all-gathered along
the width.  The backward is autograd's: the slab gather hands each rank
its own slab's gradient, the compositor's kernels run on it, and the
screen gather's backward, a reduce-scatter, sums every slab's gradient of
each Gaussian on the rank that holds it (JAX's transpose of
``all_gather``).
"""
from __future__ import annotations

import torch

from ..ops.rasterizer import (
    CHUNK,
    TileBinning,
    _tile_grid,
    bin_gaussians,
    build_instance_rows,
    composite_tiles,
    finish_image,
    tiles_to_image,
)
from ..ops.rendering import Screen, preprocess_gaussians
from .distributed import (
    all_gather_cat, all_gather_plain, all_reduce_sum, gather_replicated, group_rank,
)


def slab_capacity(capacity: int, world: int, per_device_capacity: int | None = None) -> int:
    """A rank's instance budget for its slab, rounded up to 128: by default
    2x the uniform share, 4x at >= 8 ranks (a slab is then a small part of
    the screen and hot spots concentrate), never above ``capacity``, as in
    JAX.  An undersized slab is reported through the summed ``dropped``."""
    if per_device_capacity is None:
        margin = 4 if world >= 8 else 2
        per_device_capacity = min(capacity, margin * capacity // world)
    return -(-max(per_device_capacity, CHUNK) // CHUNK) * CHUNK


def gather_screen(screen: Screen, group) -> Screen:
    """Every rank's screen parameters, in rank order.  The ten
    differentiable columns travel in one gather whose backward is a
    reduce-scatter; the radius and the mask in one without gradient."""
    cols = torch.cat([screen.means2d, screen.conics, screen.colors,
                      screen.opacities[:, None], screen.depths[:, None]], dim=-1)
    cols = all_gather_cat(cols, group)
    aux = all_gather_plain(torch.stack([screen.radii, screen.mask.to(screen.radii.dtype)], -1),
                           group)
    return Screen(means2d=cols[:, 0:2], conics=cols[:, 2:5], colors=cols[:, 5:8],
                  opacities=cols[:, 8], depths=cols[:, 9], radii=aux[:, 0],
                  mask=aux[:, 1] > 0)


def render_slab(
    screen: Screen,
    rank: int,
    world: int,
    image_shape: tuple[int, int],
    capacity: int,
) -> tuple[torch.Tensor, TileBinning, torch.Tensor]:
    """Rank ``rank``'s slab of a ``world``-way split of the image's tile
    columns, from the screen parameters of all the Gaussians: its
    binning (at most ``capacity`` raw instances), its instance rows and
    the composite, the CUDA kernels at ``col_offset = rank * local_cols``.
    Returns (slab image (th * 16, local_cols * 16, 5), binning, instance
    rows).  The slabs of ranks 0..world-1, side by side, are the image
    ``rasterize`` composites at the same budget."""
    tw = _tile_grid(image_shape)[1]
    if tw % world:
        raise ValueError(f"{tw} tile columns do not split over {world} ranks")
    local_cols = tw // world
    col_offset = rank * local_cols
    capacity = -(-capacity // CHUNK) * CHUNK
    binning = bin_gaussians(screen, image_shape, capacity, num_local_cols=local_cols,
                            col_offset=col_offset)
    inst = build_instance_rows(screen, binning)
    out = composite_tiles(inst, binning.tile_start, binning.tile_count, local_cols,
                          col_offset=col_offset)
    return tiles_to_image(out, local_cols), binning, inst


def rasterize_sharded(
    means: torch.Tensor,  # (n_local, 3): this rank's shard
    covariances: torch.Tensor,
    harmonics: torch.Tensor,
    opacities: torch.Tensor,
    extrinsics: torch.Tensor,  # (4, 4), the same on every rank
    intrinsics: torch.Tensor,
    image_shape: tuple[int, int],
    background: torch.Tensor,
    sh_degree: int,
    group=None,
    capacity: int | None = None,
    per_device_capacity: int | None = None,
    return_stats: bool = False,
):
    """Render one view with the Gaussians and the tile columns split over
    the ranks of ``group`` (None: one process).  Every rank passes a shard
    of the same size.

    Returns (color (h, w, 3), depth (h, w), alpha (h, w)), the whole image
    on every rank; with ``return_stats`` a fourth element
    {"dropped": () int64}, the instances every slab's budget cut, summed
    over the ranks.  ``capacity`` is the whole view's budget (default
    max(3 n, 32768), n the Gaussians of all shards), ``per_device_capacity``
    a slab's (default ``slab_capacity``).  The tile columns must split
    evenly over the ranks."""
    rank, world = group_rank(group)
    n = means.shape[0] * world
    if capacity is None:
        capacity = max(3 * n, 32768)
    local_capacity = slab_capacity(capacity, world, per_device_capacity)
    screen = preprocess_gaussians(means, covariances, harmonics, opacities, extrinsics,
                                  intrinsics, image_shape, sh_degree)
    slab, binning, _ = render_slab(gather_screen(screen, group), rank, world, image_shape,
                                   local_capacity)
    img = gather_replicated(slab, group, dim=1)
    color, depth, alpha = finish_image(img, image_shape, background)
    if return_stats:
        return color, depth, alpha, {"dropped": all_reduce_sum(binning.dropped, group)}
    return color, depth, alpha
