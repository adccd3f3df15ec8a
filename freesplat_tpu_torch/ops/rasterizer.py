"""Tile rasterizer: host-side binning plus a hand-written CUDA compositor.

Port of ``freesplat_tpu/ops/rasterizer.py`` (forward only; the backward
kernel comes with the training slice).

1.  Preprocessing (``ops/rendering.py``) is plain tensor code.
2.  Binning is tensor code without gradients: CUDA ``getRect`` tile
    bounds, a run-length decode of the per-Gaussian tile rectangles
    (``repeat_interleave``), the exact ellipse-tile prune, and one stable
    sort by (tile, depth) packed into an int64 key.  The raw ``capacity``
    cut happens before the prune, as in the JAX package, so ``dropped``
    and ``num_instances`` agree with it exactly.
3.  Compositing is ``csrc/rasterize_fwd.cu`` (one block per 16x16 tile),
    launched by ``composite_tiles`` for CUDA tensors.  For CPU tensors
    ``composite_tiles`` runs ``composite_tiles_plain``, the same
    arithmetic in PyTorch, which is also the kernel's judge on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .rendering import (
    ALPHA_MAX, ALPHA_MIN, TILE, TRANSMITTANCE_EPS, Screen, preprocess_gaussians,
)

P = TILE * TILE  # pixels per tile
CHUNK = 128  # capacity rounding granule (the JAX package's lane width)
MAX_TILE_INSTANCES = 16384  # per-tile cap (JAX MAX_CHUNKS * CHUNK)
CAPACITY_FLOOR = 32768
OUT_CH = 5  # r g b depth logT

# Kernel launches by wrapper since the last reset (one per launch).
launch_count = {"rasterize_fwd": 0}


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
    screen: Screen, image_shape: tuple[int, int], capacity: int
) -> TileBinning:
    """Assign Gaussians to tiles, sorted by (tile, depth)."""
    th, tw = _tile_grid(image_shape)
    num_tiles = th * tw
    dev = screen.means2d.device
    n = screen.means2d.shape[0]
    mx = screen.means2d[:, 0]
    my = screen.means2d[:, 1]
    r = screen.radii
    ok = screen.mask & (r > 0)

    # CUDA getRect: [floor((p - r) / B), floor((p + r + B - 1) / B)), clamped.
    x0 = torch.clamp(torch.floor((mx - r) / TILE), 0, tw).long()
    y0 = torch.clamp(torch.floor((my - r) / TILE), 0, th).long()
    x1 = torch.clamp(torch.floor((mx + r + TILE - 1) / TILE), 0, tw).long()
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
    rx0 = tx.float() * TILE - mxg
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

    tile = (ty * tw + tx)[keep]
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
    return packed[binning.sorted_ids].contiguous()


def _pixel_coords(num_tiles: int, tiles_x: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(num_tiles, P) integer pixel coordinates as float (no +0.5)."""
    t = torch.arange(num_tiles, device=device)[:, None]
    i = torch.arange(P, device=device)[None, :]
    px = ((t % tiles_x) * TILE + i % TILE).float()
    py = ((t // tiles_x) * TILE + i // TILE).float()
    return px, py


def composite_tiles_plain(
    inst: torch.Tensor,  # (k, 10) f32
    tile_start: torch.Tensor,  # (num_tiles,) i32
    tile_count: torch.Tensor,  # (num_tiles,) i32
    tiles_x: int,
    count_pairs: bool = False,
):
    """Plain PyTorch version of ``csrc/rasterize_fwd.cu``.

    Walks instance j of every tile at once, front to back, with the
    kernel's arithmetic step for step.  Returns (num_tiles, P, 5):
    r, g, b, unnormalized depth, log T; with ``count_pairs`` also the
    number of (pixel, instance) pairs evaluated before termination."""
    num_tiles = tile_start.shape[0]
    dev = inst.device
    px, py = _pixel_coords(num_tiles, tiles_x, dev)
    cnt = torch.clamp(tile_count.long(), max=MAX_TILE_INSTANCES)
    start = tile_start.long()
    log_t = torch.zeros(num_tiles, P, device=dev)
    trans = torch.ones(num_tiles, P, device=dev)
    acc = torch.zeros(num_tiles, P, 4, device=dev)
    done = torch.zeros(num_tiles, P, dtype=torch.bool, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    steps = int(cnt.max()) if num_tiles else 0
    for j in range(steps):
        if j % 64 == 0 and j and bool((done | (cnt <= j)[:, None]).all()):
            break  # every pixel terminated or ran out of instances
        live = (j < cnt)[:, None]
        if count_pairs:
            pairs = pairs + (live & ~done).sum()
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
        w = torch.where(blend, alpha * trans, 0.0)
        acc = acc + w[..., None] * d[:, None, 6:10]
        log_t = torch.where(blend, log_t_next, log_t)
        trans = torch.where(blend, trans_next, trans)
        done = done | stop
    out = torch.cat([acc, log_t[..., None]], dim=-1)
    return (out, int(pairs)) if count_pairs else out


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The C entry point of csrc/rasterize_fwd.cu (built at first use)."""
    from ..utils.cuda_build import load_library

    fn = load_library("rasterize_fwd").freesplat_rasterize_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


def composite_tiles(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tiles_x: int,
) -> torch.Tensor:
    """Composite every tile: (num_tiles, P, 5) = r, g, b, depth, log T.

    CUDA tensors launch the ``rasterize_fwd`` kernel (and count the launch);
    CPU tensors take ``composite_tiles_plain``.  Forward only: inputs that
    require grad are refused until the backward kernel exists."""
    if inst.requires_grad:
        raise RuntimeError(
            "composite_tiles has no backward yet; call it under torch.no_grad()"
        )
    if inst.device.type == "cpu":
        return composite_tiles_plain(inst, tile_start, tile_count, tiles_x)
    if inst.device.type != "cuda":
        raise RuntimeError(f"composite_tiles: unsupported device {inst.device}")
    num_tiles = tile_start.shape[0]
    for name, x, dtype in (
        ("inst", inst, torch.float32),
        ("tile_start", tile_start, torch.int32),
        ("tile_count", tile_count, torch.int32),
    ):
        if x.device != inst.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"composite_tiles: {name} must be a contiguous {dtype} tensor "
                f"on {inst.device}, got {x.dtype} on {x.device}"
            )
    if inst.dim() != 2 or inst.shape[1] != 10:
        raise ValueError(f"composite_tiles: inst must be (k, 10), got {tuple(inst.shape)}")
    if tile_count.shape != (num_tiles,) or num_tiles % tiles_x:
        raise ValueError("composite_tiles: tile_start/tile_count/tiles_x disagree")

    fn = _kernel_entry()
    out = torch.empty((num_tiles, P, OUT_CH), dtype=torch.float32, device=inst.device)
    with torch.cuda.device(inst.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            inst.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
            num_tiles, tiles_x, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"rasterize_fwd launch failed: cudaError {rc}")
    launch_count["rasterize_fwd"] += 1
    return out


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
    h, w = image_shape
    if capacity is None:
        capacity = render_capacity(means.shape[0], 3.0)
    capacity = -(-capacity // CHUNK) * CHUNK

    screen = preprocess_gaussians(
        means, covariances, harmonics, opacities, extrinsics, intrinsics,
        image_shape, sh_degree,
    )
    binning = bin_gaussians(screen, image_shape, capacity)
    inst = build_instance_rows(screen, binning)
    th, tw = _tile_grid(image_shape)
    out = composite_tiles(inst, binning.tile_start, binning.tile_count, tw)

    img = out.reshape(th, tw, TILE, TILE, OUT_CH).permute(0, 2, 1, 3, 4)
    img = img.reshape(th * TILE, tw * TILE, OUT_CH)[:h, :w]
    t_final = torch.exp(img[..., 4])
    color = img[..., 0:3] + t_final[..., None] * background
    depth = img[..., 3]
    if return_stats:
        stats = {"dropped": binning.dropped, "num_instances": binning.num_instances}
        return color, depth, 1.0 - t_final, stats
    return color, depth, 1.0 - t_final
