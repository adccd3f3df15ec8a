"""Tile rasterizer: host-side binning plus a hand-written CUDA compositor.

Port of ``freesplat_tpu/ops/rasterizer.py``, forward and backward.

1.  Preprocessing (``ops/rendering.py``) is plain tensor code.
2.  Binning is tensor code without gradients: CUDA ``getRect`` tile
    bounds, a run-length decode of the per-Gaussian tile rectangles
    (``repeat_interleave``), the exact ellipse-tile prune, and one stable
    sort by (tile, depth) packed into an int64 key.  The raw ``capacity``
    cut happens before the prune, as in the JAX package, so ``dropped``
    and ``num_instances`` agree with it exactly.
3.  Compositing is ``composite_tiles``, a ``torch.autograd.Function``:
    its forward is ``csrc/rasterize_fwd.cu`` and its backward
    ``csrc/rasterize_bwd.cu`` (one block per 16x16 tile each) on CUDA
    tensors.  On CPU tensors it runs ``composite_tiles_plain`` and
    ``composite_tiles_plain_bwd``, the same arithmetic in PyTorch, which
    are also the kernels' judges on the card.  Gradients reach the
    Gaussians through the gather in ``build_instance_rows``
    (``ops/gather.py::take_rows``, whose backward sums each Gaussian's
    instances in a fixed order, as XLA's scatter-add outside the Pallas
    call does).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .gather import take_rows
from .rendering import (
    ALPHA_MAX, ALPHA_MIN, TILE, TRANSMITTANCE_EPS, Screen, preprocess_gaussians,
)

P = TILE * TILE  # pixels per tile
CHUNK = 128  # capacity rounding granule (the JAX package's lane width)
MAX_TILE_INSTANCES = 16384  # per-tile cap (JAX MAX_CHUNKS * CHUNK)
CAPACITY_FLOOR = 32768
OUT_CH = 5  # r g b depth logT
NWARP = P // 32  # warps of a kernel block, one thread per pixel
WARP_COLS, WARP_ROWS = 8, 4  # each warp's pixel block (csrc/tile_cull.cuh)
_CULL_K_MAX = 262144.0  # 2^18: the cull's error bound needs 32 u K <= 0.5
_CULL_COORD_MAX = 1e6  # px; beyond it the one-pixel margin may not cover rounding

# Kernel launches by wrapper since the last reset (one per launch).
launch_count = {"rasterize_fwd": 0, "rasterize_bwd": 0}


def render_capacity(num_gaussians: int, factor: float) -> int:
    """Static instance budget: max(factor * n, 32768) rounded up to 128."""
    capacity = max(int(factor * num_gaussians), CAPACITY_FLOOR)
    return -(-capacity // CHUNK) * CHUNK


class TileBinning(NamedTuple):
    sorted_ids: torch.Tensor  # (k,) int64 Gaussian index per instance
    tile_start: torch.Tensor  # (num_tiles,) int32 first instance of tile
    tile_count: torch.Tensor  # (num_tiles,) int32 instances in tile
    num_instances: torch.Tensor  # () int64 tile-rect instances before any cut
    dropped: torch.Tensor  # () int64 capacity cut + per-tile cap


def _tile_grid(image_shape: tuple[int, int]) -> tuple[int, int]:
    h, w = image_shape
    return -(-h // TILE), -(-w // TILE)


@torch.no_grad()
def bin_gaussians(
    screen: Screen, image_shape: tuple[int, int], capacity: int,
    num_local_cols: int | None = None, col_offset: int = 0,
) -> TileBinning:
    """Assign Gaussians to tiles, sorted by (tile, depth).

    ``num_local_cols``/``col_offset`` restrict the binning to the slab of
    tile columns [col_offset, col_offset + num_local_cols), as the JAX
    package's: each rank of the sharded render bins its own slab
    (``parallel/sharded_render.py``).  Tile ids are then row-major over
    (th, num_local_cols); the rectangles are shifted and clamped to the
    slab, and the prune measures from the absolute column.  The defaults
    bin the whole image."""
    th, tw = _tile_grid(image_shape)
    if num_local_cols is None:
        num_local_cols = tw
    num_tiles = th * num_local_cols
    dev = screen.means2d.device
    n = screen.means2d.shape[0]
    mx = screen.means2d[:, 0]
    my = screen.means2d[:, 1]
    r = screen.radii
    ok = screen.mask & (r > 0)

    # CUDA getRect: [floor((p - r) / B), floor((p + r + B - 1) / B)), clamped
    # (the columns to the slab, after the shift by its offset).
    x0 = torch.clamp(torch.floor((mx - r) / TILE) - col_offset, 0, num_local_cols).long()
    y0 = torch.clamp(torch.floor((my - r) / TILE), 0, th).long()
    x1 = torch.clamp(torch.floor((mx + r + TILE - 1) / TILE) - col_offset, 0,
                     num_local_cols).long()
    y1 = torch.clamp(torch.floor((my + r + TILE - 1) / TILE), 0, th).long()
    span_x = x1 - x0
    count = torch.where(ok, span_x * (y1 - y0), 0)
    cum = torch.cumsum(count, 0)
    offsets = cum - count
    total = count.sum()

    # Only the first ``capacity`` raw instances are decoded (the cut comes
    # before the prune).
    kept = torch.minimum(torch.clamp(capacity - offsets, min=0), count)
    n_slots = int(min(int(total), capacity))
    gid = torch.repeat_interleave(
        torch.arange(n, device=dev), kept, output_size=n_slots
    )
    local = torch.arange(n_slots, device=dev) - offsets[gid]
    sw = torch.clamp(span_x, min=1)[gid]
    lq = torch.div(local, sw, rounding_mode="floor")
    ty = y0[gid] + lq
    tx = x0[gid] + (local - lq * sw)

    # Exact ellipse-rect prune: drop the instance when the conic quadratic's
    # minimum over the tile's pixel rect exceeds the alpha-cut level
    # 2 ln(op / ALPHA_MIN) (its alpha is below the cut at every pixel).
    mxg = mx[gid]
    myg = my[gid]
    ca = torch.clamp(screen.conics[gid, 0], min=1e-12)
    cb = screen.conics[gid, 1]
    cc = torch.clamp(screen.conics[gid, 2], min=1e-12)
    thr = 2.0 * torch.log(
        torch.clamp(screen.opacities[gid], min=1e-12) / (1.0 / 255.0)
    )
    rx0 = (col_offset + tx).float() * TILE - mxg
    ry0 = ty.float() * TILE - myg
    rx1 = rx0 + (TILE - 1)
    ry1 = ry0 + (TILE - 1)

    def qval(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def edge_x(dx):  # min over dy in [ry0, ry1] at fixed dx
        return qval(dx, clip(-cb * dx / cc, ry0, ry1))

    def edge_y(dy):
        return qval(clip(-cb * dy / ca, rx0, rx1), dy)

    qmin = torch.minimum(
        torch.minimum(edge_x(rx0), edge_x(rx1)),
        torch.minimum(edge_y(ry0), edge_y(ry1)),
    )
    inside = (rx0 <= 0) & (rx1 >= 0) & (ry0 <= 0) & (ry1 >= 0)
    keep = inside | (qmin <= thr)

    tile = (ty * num_local_cols + tx)[keep]
    gid = gid[keep]
    # One stable sort on (tile << 32 | depth bits): kept depths are > 0.2,
    # so their float32 bit patterns order like the floats.
    depth_bits = screen.depths[gid].contiguous().view(torch.int32).long()
    order = torch.sort((tile << 32) | depth_bits, stable=True).indices
    sorted_ids = gid[order]

    tile_count = torch.bincount(tile, minlength=num_tiles)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    cap_dropped = torch.clamp(total - capacity, min=0)
    clamp_dropped = torch.clamp(tile_count - MAX_TILE_INSTANCES, min=0).sum()
    return TileBinning(
        sorted_ids=sorted_ids,
        tile_start=tile_start.int(),
        tile_count=tile_count.int(),
        num_instances=total,
        dropped=cap_dropped + clamp_dropped,
    )


def build_instance_rows(screen: Screen, binning: TileBinning) -> torch.Tensor:
    """Gather the (k, 10) instance array in (tile, depth) order.

    Columns: mx, my, conic_a, conic_b, conic_c, opacity, r, g, b, depth."""
    packed = torch.cat(
        [
            screen.means2d,
            screen.conics,
            screen.opacities[:, None],
            screen.colors,
            screen.depths[:, None],
        ],
        dim=-1,
    ).float()
    # A Gaussian's row repeats once per tile it covers: ``take_rows`` sums
    # their gradients in a fixed order (``ops/gather.py``).
    return take_rows(packed, binning.sorted_ids)


def _pixel_coords(num_tiles: int, tiles_x: int, device,
                  col_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(num_tiles, P) integer pixel coordinates as float (no +0.5) of the
    tiles row-major over (num_tiles / tiles_x, tiles_x) whose first column
    is the image's tile column ``col_offset`` (the TPU kernel's
    ``tw_ref = [tiles_x_local, col_off]``)."""
    t = torch.arange(num_tiles, device=device)[:, None]
    i = torch.arange(P, device=device)[None, :]
    px = ((col_offset + t % tiles_x) * TILE + i % TILE).float()
    py = ((t // tiles_x) * TILE + i // TILE).float()
    return px, py


def composite_tiles_plain(
    inst: torch.Tensor,  # (k, 10) f32
    tile_start: torch.Tensor,  # (num_tiles,) i32
    tile_count: torch.Tensor,  # (num_tiles,) i32
    tiles_x: int,
    count_pairs: bool = False,
    col_offset: int = 0,
):
    """Plain PyTorch version of ``csrc/rasterize_fwd.cu``.

    Walks instance j of every tile at once, front to back, with the
    kernel's arithmetic step for step.  Returns (out, walk): out
    (num_tiles, P, 5) = r, g, b, unnormalized depth, log T; walk
    (num_tiles, P) int32, one past the last instance each pixel blended
    (the backward's residual).  With ``count_pairs`` a third element
    counts the (pixel, instance) pairs evaluated before termination, and
    of those the pairs blended and the pairs that terminated a pixel:
    (evaluated, blended, stopped).  ``col_offset``: the image tile column
    of the first of the ``tiles_x`` columns (``_pixel_coords``)."""
    num_tiles = tile_start.shape[0]
    dev = inst.device
    px, py = _pixel_coords(num_tiles, tiles_x, dev, col_offset)
    cnt = torch.clamp(tile_count.long(), max=MAX_TILE_INSTANCES)
    start = tile_start.long()
    log_t = torch.zeros(num_tiles, P, device=dev)
    trans = torch.ones(num_tiles, P, device=dev)
    acc = torch.zeros(num_tiles, P, 4, device=dev)
    done = torch.zeros(num_tiles, P, dtype=torch.bool, device=dev)
    walk = torch.zeros(num_tiles, P, dtype=torch.int32, device=dev)
    pairs = torch.zeros(3, dtype=torch.int64, device=dev)
    steps = int(cnt.max()) if num_tiles else 0
    for j in range(steps):
        if j % 64 == 0 and j and bool((done | (cnt <= j)[:, None]).all()):
            break  # every pixel terminated or ran out of instances
        live = (j < cnt)[:, None]
        d = inst[torch.where(j < cnt, start + j, 0)]  # (num_tiles, 10)
        dx = px - d[:, 0:1]
        dy = py - d[:, 1:2]
        power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) - d[:, 3:4] * dx * dy
        alpha = torch.clamp(d[:, 5:6] * torch.exp(power), max=ALPHA_MAX)
        cut = (power > 0.0) | (alpha < ALPHA_MIN) | ~live | done
        log_t_next = log_t + torch.log1p(-alpha)
        trans_next = torch.exp(log_t_next)
        stop = ~cut & (trans_next < TRANSMITTANCE_EPS)
        blend = ~cut & ~stop
        if count_pairs:
            pairs = pairs + torch.stack([(live & ~done).sum(), blend.sum(), stop.sum()])
        w = torch.where(blend, alpha * trans, 0.0)
        acc = acc + w[..., None] * d[:, None, 6:10]
        log_t = torch.where(blend, log_t_next, log_t)
        trans = torch.where(blend, trans_next, trans)
        walk = torch.where(blend, j + 1, walk)
        done = done | stop
    out = torch.cat([acc, log_t[..., None]], dim=-1)
    return (out, walk, tuple(pairs.tolist())) if count_pairs else (out, walk)


def composite_tiles_plain_bwd(
    inst: torch.Tensor,  # (k, 10) f32
    tile_start: torch.Tensor,  # (num_tiles,) i32
    tile_count: torch.Tensor,  # (num_tiles,) i32
    tiles_x: int,
    out: torch.Tensor,  # (num_tiles, P, 5) forward output
    walk: torch.Tensor,  # (num_tiles, P) i32 forward residual
    grad: torch.Tensor,  # (num_tiles, P, 5) cotangent of ``out``
    count_pairs: bool = False,
    col_offset: int = 0,
):
    """Plain PyTorch version of ``csrc/rasterize_bwd.cu``: d loss / d inst.

    Walks instance index j of every tile at once, back to front from the
    largest walk, with the kernel's per-pixel arithmetic: T before j comes
    from the final log T (``log T_j = log T_{j+1} - log1p(-alpha_j)``), the
    strict suffix sum S_j = sum_{k>j} w_k (g.c_k) is carried, and

        dalpha = (g.c) T_j - (S_j + dL/dlogT) / max(1 - alpha, 1e-6)

    on the instances the forward blended; dpow = dalpha * alpha_u where
    alpha_u <= 0.99 (zero subgradient of the clamp).  The per-instance sums
    over the tile's pixels give the (k, 10) rows; rows no pixel reached
    are zero.  With ``count_pairs`` also returns the (pixel, instance)
    pairs walked and, of those, the pairs that contributed.
    ``col_offset`` as in the forward."""
    num_tiles = tile_start.shape[0]
    dev = inst.device
    px, py = _pixel_coords(num_tiles, tiles_x, dev, col_offset)
    cnt = torch.clamp(tile_count.long(), max=MAX_TILE_INSTANCES)
    start = tile_start.long()
    g0, g1, g2, g3, g_logt = grad.unbind(-1)
    log_t = out[..., 4].clone()
    suffix = torch.zeros(num_tiles, P, device=dev)
    dinst = torch.zeros_like(inst)
    walked = torch.zeros((), dtype=torch.int64, device=dev)
    contributed = torch.zeros((), dtype=torch.int64, device=dev)
    steps = int(walk.max()) if walk.numel() else 0
    for j in reversed(range(steps)):
        has = j < cnt
        d = inst[torch.where(has, start + j, 0)]  # (num_tiles, 10)
        dx = px - d[:, 0:1]
        dy = py - d[:, 1:2]
        power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) - d[:, 3:4] * dx * dy
        alpha_u = d[:, 5:6] * torch.exp(power)
        alpha = torch.clamp(alpha_u, max=ALPHA_MAX)
        contrib = (j < walk) & ~((power > 0.0) | (alpha < ALPHA_MIN))
        if count_pairs:
            walked = walked + (j < walk).sum()
            contributed = contributed + contrib.sum()
        log_t0 = log_t - torch.log1p(-alpha)
        t_excl = torch.exp(log_t0)
        w = torch.where(contrib, alpha * t_excl, 0.0)
        cg = g0 * d[:, 6:7] + g1 * d[:, 7:8] + g2 * d[:, 8:9] + g3 * d[:, 9:10]
        dalpha = cg * t_excl - (suffix + g_logt) / torch.clamp(1.0 - alpha, min=1e-6)
        dpow = torch.where(contrib & (alpha_u <= ALPHA_MAX), dalpha * alpha_u, 0.0)
        pdx = dpow * dx
        pdy = dpow * dy
        s = torch.stack(
            [dpow, pdx, pdy, pdx * dx, pdy * dy, pdx * dy, w * g0, w * g1, w * g2, w * g3],
            dim=-1,
        ).sum(1)  # (num_tiles, 10)
        op = d[:, 5]
        row = torch.stack(
            [
                d[:, 2] * s[:, 1] + d[:, 3] * s[:, 2],
                d[:, 4] * s[:, 2] + d[:, 3] * s[:, 1],
                -0.5 * s[:, 3],
                -s[:, 5],
                -0.5 * s[:, 4],
                torch.where(op > 0.0, s[:, 0] / torch.where(op > 0.0, op, 1.0), 0.0),
                s[:, 6], s[:, 7], s[:, 8], s[:, 9],
            ],
            dim=-1,
        )
        dinst[(start + j)[has]] = row[has]
        log_t = torch.where(contrib, log_t0, log_t)
        suffix = torch.where(contrib, suffix + w * cg, suffix)
    return (dinst, int(walked), int(contributed)) if count_pairs else dinst


def warp_pixels() -> torch.Tensor:
    """(8, 32) int64: the tile pixel (row * 16 + col) of each warp's lanes in
    both kernels; warp w owns the 8x4 block at column 8 (w % 2), row
    4 (w // 2) (``csrc/tile_cull.cuh::pixel_of_thread``)."""
    i = torch.arange(P)
    w, lane = i // 32, i % 32
    col = WARP_COLS * (w % 2) + lane % WARP_COLS
    row = WARP_ROWS * (w // 2) + lane // WARP_COLS
    return (row * TILE + col).reshape(NWARP, 32)


def _row_tiles(tile_start: torch.Tensor, tile_count: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) tile of each instance row (rows are grouped by tile)."""
    num_tiles = tile_start.shape[0]
    return torch.repeat_interleave(torch.arange(num_tiles, device=tile_count.device),
                                   tile_count.long(), output_size=k)


def warp_cull_mask_plain(
    inst: torch.Tensor,  # (k, 10) f32
    tile_start: torch.Tensor,  # (num_tiles,) i32
    tile_count: torch.Tensor,  # (num_tiles,) i32
    tiles_x: int,
    col_offset: int = 0,
) -> torch.Tensor:
    """(k, 8) bool: may instance row r pass the cut at any pixel of warp w?

    Plain version of ``csrc/tile_cull.cuh::warp_mask``, which both kernels
    use to skip (warp, instance) pairs: the bounding box of the ellipse
    q <= (2 ln(op / ALPHA_MIN) + 1e-4) / (1 - 32 u K), K = (a + c)^2 / det,
    against the warp's 8x4 pixel block grown by one pixel.  Conservative:
    every bit is set where the bounds behind it do not hold (a non-finite
    field, a conic not positive definite, K > 2^18, a mean or an extent
    beyond 1e6 px), none where op < ALPHA_MIN (the header has the proof)."""
    tile = _row_tiles(tile_start, tile_count, inst.shape[0])
    x0 = ((col_offset + tile % tiles_x) * TILE).float()
    y0 = ((tile // tiles_x) * TILE).float()
    mx, my, a, b, c, op = inst[:, :6].unbind(1)
    finite = torch.isfinite(inst[:, :6]).all(1)
    det_d = a.double() * c.double() - b.double() * b.double()
    det = det_d.float()
    k = (a + c) * (a + c) / det
    thr = (2.0 * torch.log(op / ALPHA_MIN) + 1e-4) / (1.0 - 32.0 * 2.0 ** -24 * k)
    ex = torch.sqrt(thr * c / det) * (1.0 + 1e-5)
    ey = torch.sqrt(thr * a / det) * (1.0 + 1e-5)
    bounded = ((a > 0) & (c > 0) & (det_d > 0) & (k <= _CULL_K_MAX)
               & (mx.abs() <= _CULL_COORD_MAX) & (my.abs() <= _CULL_COORD_MAX)
               & (ex <= _CULL_COORD_MAX) & (ey <= _CULL_COORD_MAX))

    def overlap(m, e, lo0, n, width):
        lo = lo0[:, None] + width * torch.arange(n, device=inst.device) - 1.0
        hi = lo + (width + 1)
        return ((m - e)[:, None] <= hi) & ((m + e)[:, None] >= lo)

    cols = overlap(mx, ex, x0, TILE // WARP_COLS, WARP_COLS)  # (k, 2)
    rows = overlap(my, ey, y0, TILE // WARP_ROWS, WARP_ROWS)  # (k, 4)
    w = torch.arange(NWARP, device=inst.device)
    box = cols[:, w % 2] & rows[:, w // 2]
    mask = torch.where(bounded[:, None], box, True)
    mask = torch.where((op < ALPHA_MIN)[:, None], False, mask)
    return torch.where(finite[:, None], mask, True)


def warp_steps_plain(
    inst: torch.Tensor,  # (k, 10) f32
    tile_start: torch.Tensor,  # (num_tiles,) i32
    tile_count: torch.Tensor,  # (num_tiles,) i32
    tiles_x: int,
    walk: torch.Tensor,  # (num_tiles, P) i32 forward residual
    col_offset: int = 0,
) -> dict:
    """The (warp, instance) steps each kernel makes on these inputs, with
    and without the per-warp cull (``warp_cull_mask_plain``), counted by
    instance (a warp's group of 4 in the forward may end past its last).

    - ``fwd`` / ``fwd_cull``: a warp walks until its last pixel
      terminates (at the first instance past ``walk`` that passes the cut)
      or the tile's instances end;
    - ``bwd_tile_start``: every warp walks from the tile's largest walk
      (the backward before the per-warp start); ``bwd`` / ``bwd_cull``:
      each warp from its own largest walk;
    - ``bwd_reducing``: steps with a contributing lane, where a warp
      reduces its ten sums (the cull skips none of them);
    - ``fwd_cull_warp_max`` / ``bwd_cull_warp_max``: the most steps one
      warp makes with the cull (its serial chain; the block's warps run
      side by side).
    Also the tile instance count and the per-tile largest walk, max and
    mean.  ``col_offset`` as in the kernels."""
    num_tiles = tile_start.shape[0]
    dev = inst.device
    px, py = _pixel_coords(num_tiles, tiles_x, dev, col_offset)
    cnt = torch.clamp(tile_count.long(), max=MAX_TILE_INSTANCES)
    start = tile_start.long()
    walk = walk.long()
    end = cnt[:, None].expand(num_tiles, P).clone()  # one past the last step
    found = torch.zeros(num_tiles, P, dtype=torch.bool, device=dev)
    reducing = torch.zeros((), dtype=torch.int64, device=dev)
    lanes = warp_pixels().to(dev)
    for j in range(int(cnt.max()) if num_tiles else 0):
        live = (j < cnt)[:, None]
        d = inst[torch.where(j < cnt, start + j, 0)]
        dx = px - d[:, 0:1]
        dy = py - d[:, 1:2]
        power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) - d[:, 3:4] * dx * dy
        alpha = torch.clamp(d[:, 5:6] * torch.exp(power), max=ALPHA_MAX)
        passed = live & ~((power > 0.0) | (alpha < ALPHA_MIN))
        stop = passed & (j >= walk) & ~found
        end = torch.where(stop, j + 1, end)
        found = found | stop
        reducing = reducing + (passed & (j < walk))[:, lanes].any(-1).sum()
    fwd_end = end[:, lanes].amax(-1)  # (num_tiles, 8)
    bwd_end = walk[:, lanes].amax(-1)
    mask = warp_cull_mask_plain(inst, tile_start, tile_count, tiles_x, col_offset).long()
    csum = torch.cat([torch.zeros(1, NWARP, dtype=torch.long, device=dev), mask.cumsum(0)])

    def culled(stop_at):  # set mask bits of each (tile, warp) below stop_at
        return csum.gather(0, start[:, None] + stop_at) - csum[start]

    fwd_cull, bwd_cull = culled(fwd_end), culled(bwd_end)

    tile_walk = walk.amax(1) if num_tiles else walk.new_zeros(0)
    return {
        "tiles": num_tiles,
        "tile_count_max": int(cnt.max()) if num_tiles else 0,
        "tile_count_mean": float(cnt.float().mean()) if num_tiles else 0.0,
        "tile_walk_max": int(tile_walk.max()) if num_tiles else 0,
        "tile_walk_mean": float(tile_walk.float().mean()) if num_tiles else 0.0,
        "fwd": int(fwd_end.sum()),
        "fwd_cull": int(fwd_cull.sum()),
        "fwd_cull_warp_max": int(fwd_cull.max()) if num_tiles else 0,
        "bwd_tile_start": NWARP * int(tile_walk.sum()),
        "bwd": int(bwd_end.sum()),
        "bwd_cull": int(bwd_cull.sum()),
        "bwd_cull_warp_max": int(bwd_cull.max()) if num_tiles else 0,
        "bwd_reducing": int(reducing),
    }


@functools.lru_cache(maxsize=None)
def _kernel_entry(name: str):
    """The C entry point of csrc/<name>.cu (built at first use)."""
    from ..utils.cuda_build import load_library

    fn = getattr(load_library(name), f"freesplat_{name}")
    fn.restype = ctypes.c_int
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {
        # inst, tile_start, tile_count, num_tiles, tiles_x, col_offset, out,
        # walk, stream
        "rasterize_fwd": [ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr],
        # inst, tile_start, tile_count, num_tiles, tiles_x, col_offset,
        # fwd_out, walk, cot, dinst, stream
        "rasterize_bwd": [ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr],
    }[name]
    return fn


def _check(name: str, inst: torch.Tensor, tiles_x: int, col_offset: int, **tensors) -> None:
    """Device, dtype, contiguity and shapes of a kernel's arguments."""
    if col_offset < 0:
        raise ValueError(f"{name}: col_offset must be >= 0, got {col_offset}")
    num_tiles = tensors["tile_start"].shape[0]
    shapes = {
        "tile_start": ((num_tiles,), torch.int32),
        "tile_count": ((num_tiles,), torch.int32),
        "out": ((num_tiles, P, OUT_CH), torch.float32),
        "walk": ((num_tiles, P), torch.int32),
        "grad": ((num_tiles, P, OUT_CH), torch.float32),
    }
    if inst.dim() != 2 or inst.shape[1] != 10 or inst.dtype != torch.float32:
        raise ValueError(f"{name}: inst must be (k, 10) float32, got "
                         f"{tuple(inst.shape)} {inst.dtype}")
    for key, x in (("inst", inst), *tensors.items()):
        if key != "inst" and (tuple(x.shape), x.dtype) != shapes[key]:
            raise ValueError(f"{name}: {key} must be {shapes[key][1]} of shape "
                             f"{shapes[key][0]}, got {x.dtype} {tuple(x.shape)}")
        if x.device != inst.device or not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on {inst.device}, "
                             f"got {x.device}")
    if num_tiles % tiles_x:
        raise ValueError(f"{name}: {num_tiles} tiles is no whole number of rows of {tiles_x}")


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _kernel_entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launch_count[name] += 1


def _kernel_device(name: str, inst: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (take the plain version); any other device raises."""
    if inst.device.type == "cpu":
        return False
    if inst.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {inst.device}")
    return True


def composite_tiles_fwd(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tiles_x: int,
    col_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (num_tiles, P, 5), walk (num_tiles, P) int32): CUDA tensors
    launch the ``rasterize_fwd`` kernel (and count the launch), CPU tensors
    take ``composite_tiles_plain``.  ``col_offset``: the image tile column
    of the first of the ``tiles_x`` columns (a slab of the sharded
    render; 0 for a whole image)."""
    if not _kernel_device("rasterize_fwd", inst):
        return composite_tiles_plain(inst, tile_start, tile_count, tiles_x,
                                     col_offset=col_offset)
    _check("rasterize_fwd", inst, tiles_x, col_offset, tile_start=tile_start,
           tile_count=tile_count)
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, P, OUT_CH), dtype=torch.float32, device=inst.device)
    walk = torch.empty((num_tiles, P), dtype=torch.int32, device=inst.device)
    _launch("rasterize_fwd", inst.device, inst.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), num_tiles, tiles_x, col_offset, out.data_ptr(),
            walk.data_ptr())
    return out, walk


def composite_tiles_bwd(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tiles_x: int,
    out: torch.Tensor,
    walk: torch.Tensor,
    grad: torch.Tensor,
    col_offset: int = 0,
) -> torch.Tensor:
    """d loss / d inst (k, 10): CUDA tensors launch the ``rasterize_bwd``
    kernel (and count the launch), CPU tensors take
    ``composite_tiles_plain_bwd``.  ``col_offset`` as in the forward."""
    if not _kernel_device("rasterize_bwd", inst):
        return composite_tiles_plain_bwd(inst, tile_start, tile_count, tiles_x, out, walk, grad,
                                         col_offset=col_offset)
    _check("rasterize_bwd", inst, tiles_x, col_offset, tile_start=tile_start,
           tile_count=tile_count, out=out, walk=walk, grad=grad)
    dinst = torch.empty_like(inst)
    _launch("rasterize_bwd", inst.device, inst.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), tile_start.shape[0], tiles_x, col_offset, out.data_ptr(),
            walk.data_ptr(), grad.data_ptr(), dinst.data_ptr())
    return dinst


class _CompositeTiles(torch.autograd.Function):
    """The TPU package's custom_vjp around its two Pallas kernels."""

    @staticmethod
    def forward(ctx, inst, tile_start, tile_count, tiles_x, col_offset):
        out, walk = composite_tiles_fwd(inst, tile_start, tile_count, tiles_x,
                                        col_offset=col_offset)
        ctx.save_for_backward(inst, tile_start, tile_count, out, walk)
        ctx.tiles_x, ctx.col_offset = tiles_x, col_offset
        return out

    @staticmethod
    def backward(ctx, grad):
        inst, tile_start, tile_count, out, walk = ctx.saved_tensors
        dinst = composite_tiles_bwd(inst, tile_start, tile_count, ctx.tiles_x, out, walk,
                                    grad.contiguous(), col_offset=ctx.col_offset)
        return dinst, None, None, None, None


def composite_tiles(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tiles_x: int,
    col_offset: int = 0,
) -> torch.Tensor:
    """Composite every tile: (num_tiles, P, 5) = r, g, b, depth, log T.

    Differentiable in ``inst``: the forward is ``composite_tiles_fwd``, the
    backward ``composite_tiles_bwd`` (the CUDA kernels on CUDA tensors,
    their plain versions on CPU tensors).  The tiles are row-major over
    (num_tiles / tiles_x, tiles_x) from image tile column ``col_offset``."""
    return _CompositeTiles.apply(inst, tile_start, tile_count, tiles_x, col_offset)


def rasterize(
    means: torch.Tensor,
    covariances: torch.Tensor,
    harmonics: torch.Tensor,
    opacities: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    image_shape: tuple[int, int],
    background: torch.Tensor,
    sh_degree: int,
    capacity: int | None = None,
    return_stats: bool = False,
):
    """Render one view with the tile rasterizer.

    Same contract as ``rasterizer_ref.render_reference``: returns (color
    (h, w, 3), unnormalized depth (h, w), alpha (h, w)); with
    ``return_stats`` a fourth element {"dropped", "num_instances"} counts
    the instances cut by the capacity budget / per-tile cap.  ``capacity``
    is rounded up to 128 (default ``render_capacity(n, 3.0)``)."""
    return _rasterize(composite_tiles, means, covariances, harmonics, opacities,
                      extrinsics, intrinsics, image_shape, background, sh_degree,
                      capacity, return_stats)


def _rasterize(composite, means, covariances, harmonics, opacities, extrinsics,
               intrinsics, image_shape, background, sh_degree, capacity, return_stats):
    """``rasterize`` with the compositor ``composite`` (``composite_tiles``,
    or a function of the same signature that a probe holds against it)."""
    if capacity is None:
        capacity = render_capacity(means.shape[0], 3.0)
    capacity = -(-capacity // CHUNK) * CHUNK

    screen = preprocess_gaussians(
        means, covariances, harmonics, opacities, extrinsics, intrinsics,
        image_shape, sh_degree,
    )
    binning = bin_gaussians(screen, image_shape, capacity)
    inst = build_instance_rows(screen, binning)
    tw = _tile_grid(image_shape)[1]
    out = composite(inst, binning.tile_start, binning.tile_count, tw)
    color, depth, alpha = finish_image(tiles_to_image(out, tw), image_shape, background)
    if return_stats:
        stats = {"dropped": binning.dropped, "num_instances": binning.num_instances}
        return color, depth, alpha, stats
    return color, depth, alpha


def tiles_to_image(out: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """The compositor's (num_tiles, P, 5) tiles, row-major over
    (num_tiles / tiles_x, tiles_x), as one (th * 16, tiles_x * 16, 5)
    image (or slab of one)."""
    th = out.shape[0] // tiles_x
    img = out.reshape(th, tiles_x, TILE, TILE, OUT_CH).permute(0, 2, 1, 3, 4)
    return img.reshape(th * TILE, tiles_x * TILE, OUT_CH)


def finish_image(img: torch.Tensor, image_shape: tuple[int, int], background: torch.Tensor):
    """(color, depth, alpha) of the composited image ``img`` (padded to
    whole tiles): cropped, the background behind the final transmittance."""
    h, w = image_shape
    img = img[:h, :w]
    t_final = torch.exp(img[..., 4])
    color = img[..., 0:3] + t_final[..., None] * background
    return color, img[..., 3], 1.0 - t_final
