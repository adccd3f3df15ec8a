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
    Gaussians through the gather in ``build_instance_rows`` (torch's index
    backward, a scatter-add, as XLA's outside the Pallas call).
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
    # index_select: its backward is index_add_ (atomics on the GPU), where
    # packed[ids]'s sorts the ids first and accumulates repeats serially.
    return packed.index_select(0, binning.sorted_ids)


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
    kernel's arithmetic step for step.  Returns (out, walk): out
    (num_tiles, P, 5) = r, g, b, unnormalized depth, log T; walk
    (num_tiles, P) int32, one past the last instance each pixel blended
    (the backward's residual).  With ``count_pairs`` a third element
    counts the (pixel, instance) pairs evaluated before termination, and
    of those the pairs blended and the pairs that terminated a pixel:
    (evaluated, blended, stopped)."""
    num_tiles = tile_start.shape[0]
    dev = inst.device
    px, py = _pixel_coords(num_tiles, tiles_x, dev)
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
    pairs walked and, of those, the pairs that contributed."""
    num_tiles = tile_start.shape[0]
    dev = inst.device
    px, py = _pixel_coords(num_tiles, tiles_x, dev)
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


@functools.lru_cache(maxsize=None)
def _kernel_entry(name: str):
    """The C entry point of csrc/<name>.cu (built at first use)."""
    from ..utils.cuda_build import load_library

    fn = getattr(load_library(name), f"freesplat_{name}")
    fn.restype = ctypes.c_int
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {
        # inst, tile_start, tile_count, num_tiles, tiles_x, out, walk, stream
        "rasterize_fwd": [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr],
        # inst, tile_start, tile_count, num_tiles, tiles_x, fwd_out, walk,
        # cot, dinst, stream
        "rasterize_bwd": [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, ptr],
    }[name]
    return fn


def _check(name: str, inst: torch.Tensor, tiles_x: int, **tensors) -> None:
    """Device, dtype, contiguity and shapes of a kernel's arguments."""
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (num_tiles, P, 5), walk (num_tiles, P) int32): CUDA tensors
    launch the ``rasterize_fwd`` kernel (and count the launch), CPU tensors
    take ``composite_tiles_plain``."""
    if not _kernel_device("rasterize_fwd", inst):
        return composite_tiles_plain(inst, tile_start, tile_count, tiles_x)
    _check("rasterize_fwd", inst, tiles_x, tile_start=tile_start, tile_count=tile_count)
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, P, OUT_CH), dtype=torch.float32, device=inst.device)
    walk = torch.empty((num_tiles, P), dtype=torch.int32, device=inst.device)
    _launch("rasterize_fwd", inst.device, inst.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), num_tiles, tiles_x, out.data_ptr(), walk.data_ptr())
    return out, walk


def composite_tiles_bwd(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tiles_x: int,
    out: torch.Tensor,
    walk: torch.Tensor,
    grad: torch.Tensor,
) -> torch.Tensor:
    """d loss / d inst (k, 10): CUDA tensors launch the ``rasterize_bwd``
    kernel (and count the launch), CPU tensors take
    ``composite_tiles_plain_bwd``."""
    if not _kernel_device("rasterize_bwd", inst):
        return composite_tiles_plain_bwd(inst, tile_start, tile_count, tiles_x, out, walk, grad)
    _check("rasterize_bwd", inst, tiles_x, tile_start=tile_start, tile_count=tile_count,
           out=out, walk=walk, grad=grad)
    dinst = torch.empty_like(inst)
    _launch("rasterize_bwd", inst.device, inst.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), tile_start.shape[0], tiles_x, out.data_ptr(),
            walk.data_ptr(), grad.data_ptr(), dinst.data_ptr())
    return dinst


class _CompositeTiles(torch.autograd.Function):
    """The TPU package's custom_vjp around its two Pallas kernels."""

    @staticmethod
    def forward(ctx, inst, tile_start, tile_count, tiles_x):
        out, walk = composite_tiles_fwd(inst, tile_start, tile_count, tiles_x)
        ctx.save_for_backward(inst, tile_start, tile_count, out, walk)
        ctx.tiles_x = tiles_x
        return out

    @staticmethod
    def backward(ctx, grad):
        inst, tile_start, tile_count, out, walk = ctx.saved_tensors
        dinst = composite_tiles_bwd(inst, tile_start, tile_count, ctx.tiles_x, out, walk,
                                    grad.contiguous())
        return dinst, None, None, None


def composite_tiles(
    inst: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tiles_x: int,
) -> torch.Tensor:
    """Composite every tile: (num_tiles, P, 5) = r, g, b, depth, log T.

    Differentiable in ``inst``: the forward is ``composite_tiles_fwd``, the
    backward ``composite_tiles_bwd`` (the CUDA kernels on CUDA tensors,
    their plain versions on CPU tensors)."""
    return _CompositeTiles.apply(inst, tile_start, tile_count, tiles_x)


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
    out = composite(inst, binning.tile_start, binning.tile_count, tw)

    img = out.reshape(th, tw, TILE, TILE, OUT_CH).permute(0, 2, 1, 3, 4)
    img = img.reshape(th * TILE, tw * TILE, OUT_CH)[:h, :w]
    t_final = torch.exp(img[..., 4])
    color = img[..., 0:3] + t_final[..., None] * background
    depth = img[..., 3]
    if return_stats:
        stats = {"dropped": binning.dropped, "num_instances": binning.num_instances}
        return color, depth, 1.0 - t_final, stats
    return color, depth, 1.0 - t_final
