"""Hardware probes: the row gather, the rasterizer and the cost volume.

Port of ``freesplat_tpu/scripts/probe_r3.py``.

1. ``probe_gather``: ``o[r, l] = x[idx[r, l], l]`` at table depths up to
   hw = 96 * 128 = 12288 rows, the gather a fused plane-sweep kernel would
   need.  ``gather_rows`` launches ``csrc/gather_rows.cu`` (the port of
   the Pallas kernel ``probe_gather.k``) and is timed beside
   ``torch.gather`` as the library yardstick, both in device time
   (``device_bench``: a call is shorter than its launch from Python).
2. ``probe_raster``: forward and forward+backward of ``rasterize`` at the
   384x512 probe scene, with the compositing kernels held against their
   plain versions (the JAX probe's DOT_PRECISION A/B has no counterpart:
   the CUDA compositor has no matrix product).
3. ``probe_sweep``: forward and forward+backward of the cost volume.

Usage: python -m freesplat_tpu_torch.scripts.probe_r3 [gather|raster|sweep|all]

Each probe takes its sizes as keyword arguments whose defaults are the JAX
script's, and ``device`` (default the GPU; raises without one).
"""
from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.timing import bench, device_bench

GATHER_SHAPES = ((8, 128), (128, 128), (1024, 128), (12288, 128), (12288, 96), (12416, 192))

# Kernel launches by wrapper since the last reset (one per launch).
launch_count = {"gather_rows": 0}


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/gather_rows.cu``: o[r, l] =
    x[idx[r, l], l]; a negative index wraps, one outside [-rows, rows)
    gives NaN (jnp's ``take_along_axis``)."""
    rows = x.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + rows, i)
    ok = (i >= 0) & (i < rows)
    lane = torch.arange(x.shape[1], device=x.device)[None, :]
    return torch.where(ok, x[torch.where(ok, i, 0), lane], torch.nan)


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The C entry point of csrc/gather_rows.cu (built at first use)."""
    from ..utils.cuda_build import load_library

    fn = load_library("gather_rows").freesplat_gather_rows
    fn.restype = ctypes.c_int
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, i32, i32, ptr, ptr]  # x, idx, rows, lanes, out, stream
    return fn


def _check(x: torch.Tensor, idx: torch.Tensor) -> None:
    """Device, dtype, contiguity and shapes of the kernel's arguments."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"gather_rows: x must be (rows, lanes) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if tuple(idx.shape) != tuple(x.shape) or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: idx must be int32 of shape {tuple(x.shape)}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    for key, t in (("x", x), ("idx", idx)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"gather_rows: {key} must be contiguous on {x.device}, "
                             f"got {t.device}")


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """o[r, l] = x[idx[r, l], l] for x (rows, lanes) float32 and idx of the
    same shape, int32: CUDA tensors launch the ``gather_rows`` kernel (and
    count the launch), CPU tensors take ``gather_rows_plain``; any other
    device raises."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    if x.device.type != "cuda":
        raise RuntimeError(f"gather_rows: unsupported device {x.device}")
    _check(x, idx)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_entry()(x.data_ptr(), idx.data_ptr(), x.shape[0], x.shape[1],
                             out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows launch failed: cudaError {rc}")
    launch_count["gather_rows"] += 1
    return out


def gather_inputs(rows: int, lanes: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX probe's inputs: x from ``default_rng(0)``, idx in [0, rows)
    from ``default_rng(1)``."""
    x = np.random.default_rng(0).standard_normal((rows, lanes)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, rows, (rows, lanes)).astype(np.int32)
    return x, idx


def probe_gather(shapes=GATHER_SHAPES, device: str | torch.device = "cuda") -> list[dict]:
    """Per shape: the kernel's result against ``np.take_along_axis``
    (exactly), its device time and ``torch.gather``'s (the int64 index it
    needs is made outside the timed call).  Returns one dict per shape."""
    device = resolve_device(device)
    results = []
    for rows, lanes in shapes:
        x_np, idx_np = gather_inputs(rows, lanes)
        x = torch.from_numpy(x_np).to(device)
        idx = torch.from_numpy(idx_np).to(device)
        out = gather_rows(x, idx).cpu().numpy()
        ref = np.take_along_axis(x_np, idx_np.astype(np.int64), 0)
        if not np.array_equal(out, ref):
            raise AssertionError(f"gather ({rows},{lanes}): WRONG RESULT")
        err = float(np.abs(out - ref).max())
        idx64 = idx.long()
        ms = device_bench(gather_rows, [(x, idx)], n=20) * 1e3
        lib_ms = device_bench(lambda a, i: torch.gather(a, 0, i), [(x, idx64)], n=20) * 1e3
        el = rows * lanes
        print(f"gather ({rows},{lanes}): OK {ms:.4f} ms ({ms * 1e6 / el:.4f} ns/elem); "
              f"torch.gather {lib_ms:.4f} ms ({lib_ms * 1e6 / el:.4f} ns/elem)", flush=True)
        results.append({"rows": rows, "lanes": lanes, "ms": ms, "library_ms": lib_ms,
                        "max_abs_err": err})
    return results


class _PlainComposite(torch.autograd.Function):
    """The compositor's plain versions, forward and backward, on any
    device: what ``probe_raster`` holds the kernels against."""

    @staticmethod
    def forward(ctx, inst, tile_start, tile_count, tiles_x):
        from ..ops import rasterizer as R

        out, walk = R.composite_tiles_plain(inst, tile_start, tile_count, tiles_x)
        ctx.save_for_backward(inst, tile_start, tile_count, out, walk)
        ctx.tiles_x = tiles_x
        return out

    @staticmethod
    def backward(ctx, grad):
        from ..ops import rasterizer as R

        inst, tile_start, tile_count, out, walk = ctx.saved_tensors
        dinst = R.composite_tiles_plain_bwd(inst, tile_start, tile_count, ctx.tiles_x,
                                            out, walk, grad.contiguous())
        return dinst, None, None, None


def probe_raster(n: int = 393216, image_shape: tuple[int, int] = (384, 512),
                 device: str | torch.device = "cuda") -> dict:
    """Forward and forward+backward ms of ``rasterize`` (sh_degree 2) over
    8 perturbed copies of the JAX probe scene, then the compositing kernels
    vs their plain versions on it: color max|d|, d(loss)/d(means) max|d|
    and that relative to the largest gradient."""
    from ..ops import rasterizer as R
    from ..ops.gaussians import build_covariance

    device = resolve_device(device)
    rng = np.random.default_rng(7)
    h, w = image_shape
    means = torch.from_numpy(
        (rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 4.0])).astype(np.float32)).to(device)
    scales = torch.from_numpy(rng.uniform(0.004, 0.03, (n, 3)).astype(np.float32)).to(device)
    quats = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)).to(device)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    cov = build_covariance(scales, quats)
    sh = torch.from_numpy((rng.normal(size=(n, 3, 9)) * 0.3).astype(np.float32)).to(device)
    op = torch.sigmoid(torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(device))
    extr = torch.eye(4, device=device)
    intr = torch.tensor([[1.1, 0, 0.5], [0, 1.4667, 0.5], [0, 0, 1]], device=device)
    bg = torch.zeros(3, device=device)

    def make_args(k):
        dm = np.random.default_rng(100 + k).normal(size=(n, 3)) * 1e-3
        return (means + torch.from_numpy(dm.astype(np.float32)).to(device),)

    args_list = [make_args(k) for k in range(8)]

    def render(m, composite):
        capacity = R.render_capacity(n, 3.0)
        return R._rasterize(composite, m, cov, sh, op, extr, intr, (h, w), bg, 2,
                            capacity, False)

    def fwd(m, composite=R.composite_tiles):
        with torch.no_grad():
            return render(m, composite)[0]

    def fwdbwd(m, composite=R.composite_tiles):
        m = m.detach().requires_grad_(True)
        c, d, _ = render(m, composite)
        (c.sum() + 0.01 * d.sum()).backward()
        return m.grad

    t_f = bench(fwd, args_list) * 1e3
    t_fb = bench(fwdbwd, args_list) * 1e3
    rays = h * w
    print(f"raster: fwd {t_f:.2f} ms, fwd+bwd {t_fb:.2f} ms "
          f"({rays / t_fb * 1000 / 1e6:.3f} Mrays/s fwd+bwd)", flush=True)
    c_k, g_k = fwd(means), fwdbwd(means)
    c_p, g_p = fwd(means, _PlainComposite.apply), fwdbwd(means, _PlainComposite.apply)
    color_d = float((c_k - c_p).abs().max())
    grad_d = float((g_k - g_p).abs().max())
    grad_rel = grad_d / (float(g_p.abs().max()) + 1e-12)
    print(f"parity kernel vs plain: color max|d| = {color_d:.3e}, grad max|d| = "
          f"{grad_d:.3e}, grad rel = {grad_rel:.3e}", flush=True)
    return {"fwd_ms": t_f, "fwdbwd_ms": t_fb, "color_max_abs": color_d,
            "grad_max_abs": grad_d, "grad_rel": grad_rel}


def probe_sweep(b: int = 2, h: int = 96, w: int = 128, c: int = 48, v: int = 1,
                d: int = 128, device: str | torch.device = "cuda") -> dict:
    """Forward and forward+backward ms of the cost volume (weights from
    seed 0) at the JAX probe's shape, over 6 perturbed inputs."""
    from ..models.cost_volume import CostVolume
    from ..models.encoder import init_like_flax

    device = resolve_device(device)
    rng = np.random.default_rng(5)
    cur = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(device)
    src = torch.from_numpy(rng.standard_normal((b, v, h, w, c)).astype(np.float32)).to(device)
    k44 = np.eye(4, dtype=np.float32)
    k44[0, 0] = w * 1.1
    k44[1, 1] = h * 1.4
    k44[0, 2] = w / 2
    k44[1, 2] = h / 2
    src_T_cur = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    src_T_cur[:, :, 0, 3] = 0.15
    mod = init_like_flax(CostVolume(c, num_depth_bins=d), 0).to(device)
    geo = [
        torch.from_numpy(src_T_cur).to(device),
        torch.from_numpy(np.tile(k44, (b, v, 1, 1))).to(device),
        torch.from_numpy(np.tile(np.linalg.inv(k44), (b, 1, 1))).to(device),
        torch.full((b,), 0.5, device=device),
        torch.full((b,), 15.0, device=device),
    ]

    def fwd(cur, src):
        with torch.no_grad():
            return mod(cur, src, *geo)

    def fwdbwd(cur, src):
        cur = cur.detach().requires_grad_(True)
        src = src.detach().requires_grad_(True)
        (mod(cur, src, *geo) ** 2).sum().backward()
        return cur.grad, src.grad

    def mk(k):
        r2 = np.random.default_rng(200 + k)
        return (cur + torch.from_numpy((r2.normal(size=cur.shape) * 1e-3).astype(np.float32))
                .to(device), src)

    args_list = [mk(k) for k in range(6)]
    t_f = bench(fwd, args_list) * 1e3
    t_fb = bench(fwdbwd, args_list) * 1e3
    print(f"cost volume (b={b}, V={v}, D={d}, {h}x{w}x{c}): fwd {t_f:.2f} ms, "
          f"fwd+bwd {t_fb:.2f} ms", flush=True)
    return {"fwd_ms": t_f, "fwdbwd_ms": t_fb}


def main(argv: list[str] | None = None, device: str | torch.device = "cuda") -> dict:
    """Run the probes named by ``argv[0]`` (gather, raster, sweep or all)
    and return their results by name."""
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    if which not in ("gather", "raster", "sweep", "all"):
        raise ValueError(f"unknown probe {which!r}: gather, raster, sweep or all")
    device = resolve_device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})", flush=True)
    results = {}
    if which in ("gather", "all"):
        results["gather"] = probe_gather(device=device)
    if which in ("raster", "all"):
        results["raster"] = probe_raster(device=device)
    if which in ("sweep", "all"):
        results["sweep"] = probe_sweep(device=device)
    return results


if __name__ == "__main__":
    main()
