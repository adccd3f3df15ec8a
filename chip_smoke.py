"""Drive the PyTorch port on an NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card (nvidia-smi name and power
   limit), the torch/CUDA versions and the TF32 flags.
2. Builds every CUDA kernel from ``freesplat_tpu_torch/csrc/`` into
   ``build/kernels/`` (one nvcc per source, in parallel).
3. Kernel vs plain PyTorch version on the card: the rasterizer test cases
   at their small sizes, then the 384x512 bench scene (n = 393,216,
   seed 0, sh_degree 2).  Color/alpha atol 2e-5, depth atol 2e-4, equal
   dropped / num_instances against the CPU binning.
4. The slice: the ``scannet/2views`` preset (384x512, 2 context views,
   D = 128, fp32) with weights from a seed serves 3 numpy-made scenes of
   3 target views through ``run_test``.  The kernel launch counter must
   rise by exactly the views rendered; outputs finite; nothing dropped.
   One rendered view is then held against the plain compositor.
5. Prints the kernel table as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

H, W = 384, 512
DEVICE = "cuda"
TOL_COLOR, TOL_DEPTH = 2e-5, 2e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
FLOPS_PER_PAIR = 30  # per (pixel, instance) evaluation of the compositor


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_gaussians(n, seed, z_range=(1.0, 8.0), spread=2.0, scale=(0.03, 0.35),
                   sh_d=4, opacity=None):
    """A random Gaussian scene (numpy), as in the rasterizer tests."""
    import torch
    from freesplat_tpu_torch.ops.gaussians import build_covariance

    rng = np.random.default_rng(seed)
    means = rng.uniform([-spread, -spread, z_range[0]], [spread, spread, z_range[1]],
                        size=(n, 3)).astype(np.float32)
    scales = rng.uniform(*scale, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4))
    quats = (quats / np.linalg.norm(quats, axis=-1, keepdims=True)).astype(np.float32)
    cov = build_covariance(torch.from_numpy(scales), torch.from_numpy(quats)).numpy()
    harm = (rng.normal(size=(n, 3, sh_d)) * 0.4).astype(np.float32)
    opac = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    if opacity is not None:
        opac[:] = opacity
    return means, cov, harm, opac


def screen_inputs(args, shape, sh_degree, capacity, device):
    """Preprocess + bin + gather on ``device``: the compositor's inputs."""
    import torch
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.ops.rendering import preprocess_gaussians

    with torch.no_grad():
        t = [torch.from_numpy(np.asarray(a)).to(device) for a in args]
        screen = preprocess_gaussians(*t, shape, sh_degree)
        binning = R.bin_gaussians(screen, shape, capacity)
        inst = R.build_instance_rows(screen, binning)
    return inst, binning


def compare_tiles(inst, binning, tiles_x):
    """Kernel vs plain on the same inputs: (max abs error, evaluated pairs)."""
    import torch
    from freesplat_tpu_torch.ops import rasterizer as R

    with torch.no_grad():
        k = R.composite_tiles(inst, binning.tile_start, binning.tile_count, tiles_x)
        p, pairs = R.composite_tiles_plain(inst, binning.tile_start, binning.tile_count,
                                           tiles_x, count_pairs=True)
    sync()
    rgb = (k[..., 0:3] - p[..., 0:3]).abs().max().item() if k.numel() else 0.0
    alpha = (torch.exp(k[..., 4]) - torch.exp(p[..., 4])).abs().max().item() if k.numel() else 0.0
    depth = (k[..., 3] - p[..., 3]).abs().max().item() if k.numel() else 0.0
    if not (rgb <= TOL_COLOR and alpha <= TOL_COLOR and depth <= TOL_DEPTH):
        raise AssertionError(f"kernel vs plain: color {rgb} alpha {alpha} depth {depth}")
    return max(rgb, alpha, depth), pairs


def kernel_cases() -> float:
    """The rasterizer test cases, kernel vs plain on the card, with the
    binning's dropped/num_instances equal to the CPU binning's."""
    from freesplat_tpu_torch.ops import rasterizer as R

    intr = np.array([[1.1, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32)
    extr = np.eye(4, dtype=np.float32)
    cases = {
        "random_s0": (dict(n=150, seed=0), None, (64, 96)),
        "random_s1": (dict(n=150, seed=1), None, (64, 96)),
        "fuzz_near_cull": (dict(n=40, seed=11, z_range=(0.21, 0.5), spread=0.5), 64 * 40, (64, 96)),
        "fuzz_wall": (dict(n=60, seed=12, z_range=(1.0, 1.05), spread=3.0, opacity=0.98),
                      64 * 60, (64, 96)),
        "fuzz_tiny": (dict(n=5, seed=13, z_range=(2.0, 3.0), spread=0.1), 64 * 5, (64, 96)),
        "fuzz_huge_range": (dict(n=200, seed=14, z_range=(0.5, 40.0), spread=6.0),
                            64 * 200, (64, 96)),
        "dense_overlap": (dict(n=300, seed=2, z_range=(2.0, 4.0), spread=0.3, opacity=0.95),
                          64 * 300, (64, 96)),
        "culled": (dict(n=20, seed=4, z_range=(-29.0, -22.0)), None, (64, 96)),
        "capacity_clamp": (dict(n=100, seed=5), 64, (64, 96)),
        "overflow_ample": (dict(n=100, seed=5), 1600, (64, 96)),
        "nonsquare": (dict(n=60, seed=6), None, (50, 70)),
    }
    worst = 0.0
    for name, (kw, cap, shape) in cases.items():
        means, cov, harm, opac = make_gaussians(**kw)
        args = (means, cov, harm, opac, extr, intr)
        cap = R.render_capacity(kw["n"], 3.0) if cap is None else -(-cap // 128) * 128
        inst, binning = screen_inputs(args, shape, 1, cap, DEVICE)
        _, cpu_bin = screen_inputs(args, shape, 1, cap, "cpu")
        for f in ("num_instances", "dropped"):
            g, c = int(getattr(binning, f)), int(getattr(cpu_bin, f))
            if g != c:
                raise AssertionError(f"{name}: {f} on the card {g} != CPU {c}")
        err, _ = compare_tiles(inst, binning, -(-shape[1] // 16))
        worst = max(worst, err)
        log(f"[case] {name}: ok max_err {err:.3g} instances {int(binning.num_instances)} "
            f"dropped {int(binning.dropped)}")
    return worst


def time_compositor(inst, binning, tiles_x, pairs, label):
    """Kernel and plain times (CUDA events) and the bound for one input."""
    from freesplat_tpu_torch.ops import rasterizer as R

    args = (inst, binning.tile_start, binning.tile_count, tiles_x)
    saved = dict(R.launch_count)
    ms = cuda_ms(lambda: R.composite_tiles(*args), reps=20)
    plain_ms = cuda_ms(lambda: R.composite_tiles_plain(*args), reps=1)
    R.launch_count.update(saved)  # timing launches are not the main path's
    num_tiles = binning.tile_start.shape[0]
    bytes_moved = inst.numel() * 4 + num_tiles * 8 + num_tiles * 256 * 5 * 4
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * FLOPS_PER_PAIR / FP32_FLOPS * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"[time] {label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {bytes_moved} B, {pairs} pixel-instance pairs), "
        f"instances kept after the prune {inst.shape[0]}, dropped {int(binning.dropped)}")
    return ms, plain_ms, bound_ms, bound_by


def bench_scene():
    """bench.py's rasterizer workload (forward only)."""
    from freesplat_tpu_torch.ops import rasterizer as R

    n = 2 * H * W
    rng = np.random.default_rng(0)
    means = rng.uniform([-3, -3, 0.8], [3, 3, 10], size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.005, 0.03, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4))
    quats = (quats / np.linalg.norm(quats, axis=-1, keepdims=True)).astype(np.float32)
    import torch
    from freesplat_tpu_torch.ops.gaussians import build_covariance

    cov = build_covariance(torch.from_numpy(scales), torch.from_numpy(quats)).numpy()
    harm = (rng.normal(size=(n, 3, 9)) * 0.3).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, size=n).astype(np.float32)
    extr = np.eye(4, dtype=np.float32)
    intr = np.array([[1.07, 0, 0.5], [0, 1.42, 0.5], [0, 0, 1]], np.float32)
    inst, binning = screen_inputs((means, cov, harm, opac, extr, intr), (H, W), 2,
                                  R.render_capacity(n, 3.0), DEVICE)
    err, pairs = compare_tiles(inst, binning, W // 16)
    log(f"[bench] 384x512 n={n}: kernel vs plain max_err {err:.3g}, "
        f"tile-rect instances {int(binning.num_instances)}, dropped {int(binning.dropped)}")
    return err, time_compositor(inst, binning, W // 16, pairs, "bench scene")


def make_scene(seed: int, v_ctx=2, v_tgt=3):
    """Numpy views at 384x512: smooth random images, cameras on a short
    arc with the targets between the two context cameras."""
    rng = np.random.default_rng(seed)
    n = v_ctx + v_tgt
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, s in enumerate(np.linspace(0.0, 1.0, n)):
        a = 0.1 * s
        extr[i, :3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
        extr[i, :3, 3] = [0.4 * s, 0.02 * rng.standard_normal(), 0.05 * s]
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (n, 1, 1))
    coarse = rng.uniform(size=(n, H // 16, W // 16, 3))
    img = np.repeat(np.repeat(coarse, 16, axis=1), 16, axis=2)
    img = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1).astype(np.float32)
    order = [0, n - 1] + list(range(1, n - 1))
    ctx, tgt = order[:v_ctx], order[v_ctx:]

    def views(idx):
        return {
            "image": img[idx][None], "extrinsics": extr[idx][None],
            "intrinsics": intr[idx][None],
            "near": np.full((1, len(idx)), 0.5, np.float32),
            "far": np.full((1, len(idx)), 15.0, np.float32),
        }

    return {"scene": [f"numpy_scene_{seed}"], "context": views(ctx), "target": views(tgt)}


def slice_run():
    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.evaluation.harness import run_test
    from freesplat_tpu_torch.models.encoder import make_encoder
    from freesplat_tpu_torch.ops import rasterizer as R

    # Seeded random weights make splats larger than trained ones (~3.6 tile
    # instances per Gaussian where the preset's budget allows 3.0), so the
    # test-time budget is raised: the port's binning costs what the
    # instances need, not the budget, so the headroom is free.
    cfg = load_config(["+experiment=scannet/2views", "mode=test", "test.save_depth=false",
                       "test.render_capacity_factor=8.0"])
    scenes = [make_scene(s) for s in (1, 2, 3)]
    views = sum(s["target"]["image"].shape[1] for s in scenes)
    timings: dict = {}
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in R.launch_count:
        R.launch_count[k] = 0
    t0 = time.perf_counter()
    summary = run_test(cfg, batches=iter(scenes), device=DEVICE, timings=timings)
    wall = time.perf_counter() - t0
    launches = dict(R.launch_count)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    if launches["rasterize_fwd"] != views:
        raise AssertionError(f"rasterize_fwd launched {launches['rasterize_fwd']} times "
                             f"for {views} target views")
    if not all(math.isfinite(v) for v in summary.values()):
        raise AssertionError(f"non-finite summary {summary}")
    if summary["dropped_instances"] != 0:
        raise AssertionError(f"rasterizer dropped instances: {summary}")
    enc_ms = [1e3 * t for t in timings["encoder_s"]]
    dec_ms = [1e3 * t for t in timings["decoder_s_per_view"]]
    log(f"[slice] scenes 3, target views {views}, wall {wall:.2f} s, "
        f"encoder ms/scene {enc_ms}, decoder ms/view {dec_ms}, "
        f"gaussians/scene {summary['num_gaussians']:.0f}, psnr {summary['psnr']:.3f}, "
        f"peak memory {peak} B, launches {launches}")

    # One view of scene 1 through the same encoder weights: kernel vs plain
    # on the main path's own compositor inputs.
    encoder = make_encoder(cfg.encoder, device=DEVICE, seed=cfg.seed)
    sc = scenes[0]
    ctx = {k: torch.from_numpy(np.asarray(a)).to(DEVICE) for k, a in sc["context"].items()}
    tgt = {k: torch.from_numpy(np.asarray(a)).to(DEVICE) for k, a in sc["target"].items()}
    with torch.no_grad():
        g = encoder(ctx)["gaussians"]
        for f in ("means", "covariances", "harmonics", "opacities"):
            x = getattr(g, f)
            if x.shape[:2] != (1, 2 * H * W) or not torch.isfinite(x).all():
                raise AssertionError(f"encoder output {f}: shape {tuple(x.shape)} or non-finite")
        near = tgt["near"][0, 0]
        extr = tgt["extrinsics"][0, 0].clone()
        extr[:3, 3] = extr[:3, 3] / near  # the decoder's 1/near rescale
        from freesplat_tpu_torch.ops.rendering import preprocess_gaussians

        screen = preprocess_gaussians(
            g.means[0] / near, g.covariances[0] / (near * near), g.harmonics[0],
            g.masked_opacities()[0], extr, tgt["intrinsics"][0, 0], (H, W), 2,
        )
        binning = R.bin_gaussians(
            screen, (H, W),
            R.render_capacity(g.means.shape[1], cfg.test.render_capacity_factor),
        )
        inst = R.build_instance_rows(screen, binning)
    err, pairs = compare_tiles(inst, binning, W // 16)
    log(f"[slice] view 0 of scene 1: kernel vs plain max_err {err:.3g}")
    timing = time_compositor(inst, binning, W // 16, pairs, "slice view")
    if DEVICE == "cuda":
        profile_scene(encoder, cfg, ctx, tgt)
    return launches, err, timing, summary


def profile_scene(encoder, cfg, ctx, tgt):
    """torch.profiler over one warm scene (encode + 3 target views): the
    device's busy share of the host wall time and the top kernels by
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from freesplat_tpu_torch.models.decoder import render_views
    from freesplat_tpu_torch.ops import rasterizer as R

    dcfg = dataclasses.replace(cfg.decoder, capacity_factor=cfg.test.render_capacity_factor)
    saved = dict(R.launch_count)

    def one_scene():
        with torch.no_grad():
            g = encoder(ctx)["gaussians"]
            render_views(dcfg, g, tgt["extrinsics"], tgt["intrinsics"], tgt["near"],
                         tgt["far"], (H, W))
        torch.cuda.synchronize()

    one_scene()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_scene()
        wall_ms = (time.perf_counter() - t0) * 1e3
    R.launch_count.update(saved)
    # Device activity only (kernels, copies, sets): one stream, no overlap.
    kernels: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(sum(v) for v in kernels.values())
    log(f"[profile] one scene (encode + 3 views): wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for name, v in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[profile]   {sum(v):9.3f} ms  x{len(v):<5d} {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    import freesplat_tpu_torch  # noqa: F401  (sets the precision flags)
    from freesplat_tpu_torch.utils import cuda_build

    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"tf32 cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    kernels = ["rasterize_fwd"]
    cuda_build.build_all(kernels)
    log(f"[build] {kernels} in {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        log(f"[build] {k}: {cuda_build.BUILD_INFO[k]['log']}")

    worst = kernel_cases()
    bench_err, bench_t = bench_scene()
    launches, view_err, (ms, plain_ms, bound_ms, bound_by), _ = slice_run()
    log(f"[bench] compositor at the bench scene: kernel {bench_t[0]:.4f} ms, "
        f"plain {bench_t[1]:.2f} ms, bound {bench_t[2]:.4f} ms ({bench_t[3]})")

    print(json.dumps({"kernels": [{
        "name": "rasterize_fwd",
        "route": "cuda",
        "source": "freesplat_tpu_torch/csrc/rasterize_fwd.cu",
        "replaces": "freesplat_tpu/ops/rasterizer.py:378",
        "launches": launches["rasterize_fwd"],
        "max_abs_err": max(worst, bench_err, view_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
