"""Drive the PyTorch port on an NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--baseline DIR]

1. Requires a CUDA device; prints the card (nvidia-smi name and power
   limit), the torch/CUDA versions and the TF32 flags.
2. Builds every CUDA kernel from ``freesplat_tpu_torch/csrc/`` into
   ``build/kernels/`` (one nvcc per source, in parallel) and prints each
   ptxas report.
3. Kernels vs their plain PyTorch versions on the card: the rasterizer
   test cases at their small sizes, then the 384x512 bench scene
   (n = 393,216, seed 0, sh_degree 2).  Forward: bit-equal (color, depth
   and log T max |d| 0, the ``walk`` residual equal), equal dropped /
   num_instances against the CPU binning.  Backward (numpy-seeded
   cotangents): every dinst column within 2e-4 after scaling by the
   column's largest magnitude, every value finite.  At the bench scene,
   the served view and the train view: both kernels' device time
   (``utils/timing.py::device_bench``), the plain versions' time, each
   kernel's bound, the tile counts and largest walks, and the
   (warp, instance) steps of each kernel with and without the per-warp
   cull (``ops/rasterizer.py::warp_steps_plain``).  With ``--baseline
   DIR`` the rasterizer kernels built from ``DIR/rasterize_{fwd,bwd}.cu``
   (another tree's sources) are also held against these there and timed
   beside them in turns (baseline, this, this, baseline), and likewise
   ``DIR/gather_rows.cu`` in phase 6.
4. Serving: the ``scannet/2views`` preset (384x512, 2 context views,
   D = 128, fp32) with weights from a seed serves 3 numpy-made scenes of
   3 target views through ``run_test`` with the preset's defaults: PSNR,
   SSIM, LPIPS (weights from seed 111124), rendered depth against sensor
   depth with holes, frame and depth-colormap dumps and the stats files
   in a temporary directory; the second scene has an extrapolation
   target.  The forward's launch count must equal the views rendered, the
   backward's stay 0; summary finite, SSIM <= 1, the FVS split and depth
   keys present, the files written, nothing dropped.  Prints each scene's
   encode / render / metrics / dumps time.  One rendered view is held
   against the plain compositor, and one warm scene is profiled.
5. Training: ``+experiment=scannet/2views mode=train
   decoder.capacity_factor=8.0`` (8 target views, MSE + 0.05 LPIPS with
   LPIPS weights from a seed) runs ``fit`` for 5 steps.  Each kernel must
   launch 8 times per step; metrics finite; nothing dropped; every
   parameter the loss reaches and every BN running buffer moved.  Prints
   ms per step and its forward / backward / optimizer split, peak memory
   and one profiled warm step; then both kernels are held against their
   plain versions on a target view of the trained Gaussians and timed.
   Then 2 depth-supervised steps (all four ``loss.depth.*`` terms at 0.1,
   targets with sensor depth): every depth part finite and non-zero, 8
   launches of each kernel a step, and the backward kernel held against
   its plain version on the step's own cotangent (depth channel
   non-zero).  Then Replica through the CLI: ``main`` with
   ``+experiment=replica/2views mode=test`` on a 640x480 scene written in
   the dataset's layout (suffixed index key, 1 extrapolation target),
   checked as serving is.
6. Row gather: ``gather_rows`` (``csrc/gather_rows.cu``) equals its plain
   version exactly, NaN in the same places, at the six probe shapes and
   on wrapped and out-of-range indices at five shapes (lanes % 4 != 0,
   16,384 rows, x at a 4 B offset into its buffer among them).  At the
   largest shape: the device time of back-to-back calls of the kernel,
   the plain version and ``torch.gather``, with the bytes bound.
7. Probes: ``scripts/probe_r3.main(["all"])`` in-process; the gather and
   both compositing kernels must launch, the gather must equal
   ``np.take_along_axis`` at the six shapes, and the rasterizer probe's
   kernel vs plain color and gradient must agree.
8. CLI training: ``main`` with ``+experiment=scannet/2views`` on the
   synthetic stream rendered by the tile rasterizer (8 target views,
   LPIPS weights saved from a seed under ``build/``) trains 4 steps,
   checkpoints at step 2 and validates at step 3 inside a temporary
   directory; launches are checked per path (data renders, 8 of each
   kernel a train step, validation renders); then a second ``main``
   resumes from the checkpoint, whose restored tensors must equal the
   saved ones.
9. Prints the kernel table as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

H, W = 384, 512
DEVICE = "cuda"
TOL_COLOR = 2e-5  # the rasterizer probe's kernel vs plain color
TOL_GRAD = 2e-4  # after scaling by each dinst column's largest magnitude
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
# Forward, counted from csrc/rasterize_fwd.cu: every evaluated pair
# computes power and alpha and tests the cut (16 ops); a pair that passes
# adds log1p, the new log T, its exp and the termination test (20 in all:
# the pair that terminates the pixel stops there); a blended pair adds w
# and the four accumulations (29).
FLOPS_PER_PAIR_CUT, FLOPS_PER_PAIR_STOP, FLOPS_PER_PAIR = 16, 20, 29
# Backward, counted from csrc/rasterize_bwd.cu: a walked pair that the
# forward did not blend recomputes power and alpha and is cut (16 ops); a
# contributing pair does 31 more (T, w, g.c, dalpha, dpow, the ten
# products, the suffix) plus its share of the ten pixel sums (10 adds):
# 57 in all.
FLOPS_PER_PAIR_BWD_CUT, FLOPS_PER_PAIR_BWD = 16, 57
TRAIN_STEPS = 5
TRAIN_TARGET_VIEWS = 8  # the ScanNet train sampler's num_target_views
# Row gather, counted from csrc/gather_rows.cu: per element one index read,
# one value read and one value written (12 B); the wrap, the range test and
# the address take 4 integer operations.
GATHER_BYTES_PER_ELEM, GATHER_OPS_PER_ELEM = 12, 4
CLI_STEPS = 4
DEPTH_STEPS = 2  # depth-supervised fit steps
DEPTH_WEIGHTS = ("ms_gradient_weight", "scale_invariant_weight", "normals_weight",
                 "mv_consistency_weight")
LPIPS_SEED = 111124  # the training LPIPS's seed (cfg.seed + 1): no pretrained weights ship
ROOT = Path(__file__).resolve().parent
BASELINE: Path | None = None  # --baseline: another tree's csrc to time against


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


def compare_tiles(inst, binning, tiles_x, seed=0):
    """Forward and backward kernels vs their plain versions on the same
    inputs (numpy-seeded cotangent): the forward bit-equal, the backward
    within TOL_GRAD scaled.  Returns (forward max abs error,
    backward max abs error, forward (evaluated, blended, stopped) pairs,
    backward (walked, contributing) pairs, the kernel forward's (out, walk), the cotangent, and the
    backward's largest error after scaling by each column's max)."""
    import torch
    from freesplat_tpu_torch.ops import rasterizer as R

    args = (inst, binning.tile_start, binning.tile_count, tiles_x)
    with torch.no_grad():
        k, k_walk = R.composite_tiles_fwd(*args)
        p, p_walk, pairs = R.composite_tiles_plain(*args, count_pairs=True)
    sync()
    rgb, depth, log_t = ((k[..., c] - p[..., c]).abs().max().item() if k.numel() else 0.0
                         for c in (slice(0, 3), 3, 4))
    if not (rgb == 0.0 and depth == 0.0 and log_t == 0.0):
        raise AssertionError(f"forward kernel vs plain: color {rgb} depth {depth} log T {log_t}")
    if not torch.equal(k_walk, p_walk):
        raise AssertionError(f"forward kernel vs plain: walk residual differs at "
                             f"{int((k_walk != p_walk).sum())} pixels")
    rng = np.random.default_rng(seed)
    cot = torch.from_numpy(rng.standard_normal(tuple(k.shape)).astype(np.float32)).to(k.device)
    bwd_err, scaled, walked, contributed = check_bwd(args, k, k_walk, cot)
    return max(rgb, depth, log_t), bwd_err, pairs, (walked, contributed), (k, k_walk), cot, scaled


def check_bwd(args, out, walk, cot):
    """The backward kernel vs its plain version on one input: every dinst
    column within TOL_GRAD after scaling by the column's largest
    magnitude, every value finite.  Returns (max abs error, scaled error,
    walked pairs, contributing pairs)."""
    import torch
    from freesplat_tpu_torch.ops import rasterizer as R

    with torch.no_grad():
        dk = R.composite_tiles_bwd(*args, out, walk, cot)
        dp, walked, contributed = R.composite_tiles_plain_bwd(*args, out, walk, cot,
                                                              count_pairs=True)
    sync()
    bwd_err, scaled = 0.0, 0.0
    if dk.numel():
        diff = (dk - dp).abs().max(0).values
        scaled = (diff / dp.abs().max(0).values.clamp(min=1e-30)).max().item()
        bwd_err = diff.max().item()
    if not (scaled <= TOL_GRAD and bool(torch.isfinite(dk).all())):
        raise AssertionError(f"backward kernel vs plain: scaled error {scaled}, abs {bwd_err}")
    return bwd_err, scaled, walked, contributed


def kernel_cases() -> tuple[float, float]:
    """The rasterizer test cases, kernels vs plain on the card, with the
    binning's dropped/num_instances equal to the CPU binning's.  Returns
    the worst forward and backward max abs errors."""
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
    worst = (0.0, 0.0)
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
        err, bwd_err, *_, scaled = compare_tiles(inst, binning, -(-shape[1] // 16))
        worst = (max(worst[0], err), max(worst[1], bwd_err))
        log(f"[case] {name}: ok forward max_err {err:.3g} backward max_err {bwd_err:.3g} "
            f"(scaled {scaled:.3g}) instances {int(binning.num_instances)} "
            f"dropped {int(binning.dropped)}")
    return worst


def _bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=None)
def _baseline_fn(name: str):
    """The C entry point of ``BASELINE/<name>.cu``, built at first use."""
    from freesplat_tpu_torch.utils import cuda_build

    return getattr(ctypes.CDLL(str(cuda_build.build(name, csrc=BASELINE))), f"freesplat_{name}")


@contextlib.contextmanager
def baseline_kernels():
    """Inside, the rasterizer wrappers launch the kernels built from
    ``BASELINE`` (typed as this tree's) in place of this tree's."""
    from freesplat_tpu_torch.ops import rasterizer as R

    own = R._kernel_entry

    def entry(name):
        fn, ref = _baseline_fn(name), own(name)
        fn.restype, fn.argtypes = ref.restype, ref.argtypes
        return fn

    R._kernel_entry = entry
    try:
        yield
    finally:
        R._kernel_entry = own


def baseline_times(args, out, walk, cot, label):
    """The baseline kernels held against this tree's (forward bit-equal,
    backward within TOL_GRAD scaled) and both timed in device time, in
    turns: baseline, this, this, baseline."""
    import torch
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.utils.timing import device_bench

    bwd_args = (*args, out, walk, cot)
    with baseline_kernels():
        bo, bw = R.composite_tiles_fwd(*args)
        db = R.composite_tiles_bwd(*bwd_args)
    if not (torch.equal(bo, out) and torch.equal(bw, walk)):
        raise AssertionError(f"{label}: baseline forward differs from this tree's")
    dk = R.composite_tiles_bwd(*bwd_args)
    if dk.numel():
        scaled = ((dk - db).abs().max(0).values / dk.abs().max(0).values.clamp(min=1e-30)).max()
        if not float(scaled) <= TOL_GRAD:
            raise AssertionError(f"{label}: baseline backward vs this tree's: scaled {scaled}")
    for name, fn, a in (("rasterize_fwd", R.composite_tiles_fwd, args),
                        ("rasterize_bwd", R.composite_tiles_bwd, bwd_args)):
        turns = []
        for baseline in (True, False, False, True):
            with baseline_kernels() if baseline else contextlib.nullcontext():
                turns.append(device_bench(fn, [a], n=20) * 1e3)
        log(f"[time]   {name} baseline vs this tree, device ms in turns (baseline, this, "
            f"this, baseline): {', '.join(f'{t:.4f}' for t in turns)}")


def time_kernels(inst, binning, tiles_x, cmp, label):
    """Both kernels' device time (``device_bench``: back-to-back launches),
    the plain versions' (CUDA events around one call), each kernel's bound
    and the warp-steps of each kernel with and without the cull, for one
    input, from ``compare_tiles``' results ``cmp``.  With ``BASELINE`` set,
    also ``baseline_times``."""
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.utils.timing import device_bench

    _, _, pairs, (walked, contributed), (out, walk), cot, _ = cmp
    args = (inst, binning.tile_start, binning.tile_count, tiles_x)
    saved = dict(R.launch_count)
    fwd = (device_bench(R.composite_tiles_fwd, [args], n=20) * 1e3,
           cuda_ms(lambda: R.composite_tiles_plain(*args), reps=1))
    bwd = (device_bench(R.composite_tiles_bwd, [(*args, out, walk, cot)], n=20) * 1e3,
           cuda_ms(lambda: R.composite_tiles_plain_bwd(*args, out, walk, cot), reps=1))
    if BASELINE is not None:
        baseline_times(args, out, walk, cot, label)
    R.launch_count.update(saved)  # timing launches are not the main path's
    steps = R.warp_steps_plain(*args, walk)
    num_tiles = binning.tile_start.shape[0]
    k = inst.shape[0]
    # Forward: read inst and the tile ranges, write out (5 ch) and walk.
    fwd_bytes = k * 40 + num_tiles * 8 + num_tiles * 256 * (5 + 1) * 4
    # Backward: read inst, the tile ranges, out, walk and cot; write dinst.
    bwd_bytes = k * 40 + num_tiles * 8 + num_tiles * 256 * (5 + 1 + 5) * 4 + k * 40
    bwd_flops = (contributed * FLOPS_PER_PAIR_BWD
                 + (walked - contributed) * FLOPS_PER_PAIR_BWD_CUT)
    evaluated, blended, stopped = pairs
    fwd_flops = (blended * FLOPS_PER_PAIR + stopped * FLOPS_PER_PAIR_STOP
                 + (evaluated - blended - stopped) * FLOPS_PER_PAIR_CUT)
    fwd_bound = _bound(fwd_bytes, fwd_flops)
    bwd_bound = _bound(bwd_bytes, bwd_flops)
    log(f"[time] {label}: instances {k}, dropped {int(binning.dropped)}; {steps['tiles']} "
        f"tiles, instances a tile max {steps['tile_count_max']} mean "
        f"{steps['tile_count_mean']:.1f}, largest walk a tile max {steps['tile_walk_max']} "
        f"mean {steps['tile_walk_mean']:.1f}")
    log(f"[time]   warp-steps: forward {steps['fwd']} without the cull, {steps['fwd_cull']} "
        f"with; backward {steps['bwd_tile_start']} from each tile's largest walk, "
        f"{steps['bwd']} from each warp's, {steps['bwd_cull']} with the cull, "
        f"{steps['bwd_reducing']} reducing (with or without the cull); the busiest warp "
        f"{steps['fwd_cull_warp_max']} forward, {steps['bwd_cull_warp_max']} backward")
    log(f"[time]   forward: kernel {fwd[0]:.4f} ms (device time), plain {fwd[1]:.2f} ms, bound "
        f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}; {fwd_bytes} B, {evaluated} pixel-instance "
        f"pairs evaluated, {blended} blended, {stopped} terminating)")
    log(f"[time]   backward: kernel {bwd[0]:.4f} ms (device time), plain {bwd[1]:.2f} ms, bound "
        f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]}; {bwd_bytes} B, {walked} pairs walked, "
        f"{contributed} contributing)")
    return {"rasterize_fwd": (*fwd, *fwd_bound), "rasterize_bwd": (*bwd, *bwd_bound)}


def bench_scene():
    """bench.py's rasterizer workload: forward, and backward on a
    numpy-seeded cotangent."""
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
    cmp = compare_tiles(inst, binning, W // 16, seed=1)
    log(f"[bench] 384x512 n={n}: forward max_err {cmp[0]:.3g}, backward max_err {cmp[1]:.3g} "
        f"(scaled {cmp[-1]:.3g}), "
        f"tile-rect instances {int(binning.num_instances)}, dropped {int(binning.dropped)}")
    return cmp[:2], time_kernels(inst, binning, W // 16, cmp, "bench scene")


def sensor_depth(rng, n, h=None, w=None, holes=0.05):
    """(n, h, w) smooth depth maps in metres (1.5 to 4.5; default H x W)
    with ``holes`` of the pixels 0, as a depth sensor leaves them."""
    h, w = h or H, w or W
    coarse = rng.uniform(1.5, 4.5, size=(n, h // 32 + 1, w // 32 + 1))
    depth = np.repeat(np.repeat(coarse, 32, axis=1), 32, axis=2)[:, :h, :w]
    depth = depth + 0.01 * rng.standard_normal(depth.shape)
    depth[rng.uniform(size=depth.shape) < holes] = 0.0
    return depth.astype(np.float32)


def make_scene(seed: int, v_ctx=2, v_tgt=3, depth=False, test_fvs=0):
    """Numpy views at 384x512: smooth random images, cameras on a short
    arc with the targets between the two context cameras; with ``depth``
    the targets carry sensor depth (``sensor_depth``), with ``test_fvs``
    the last that many targets are extrapolation views."""
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

    target = views(tgt)
    if depth:
        target["depth"] = sensor_depth(rng, len(tgt))[None]
    if test_fvs:
        target["test_fvs"] = test_fvs
    return {"scene": [f"numpy_scene_{seed}"], "context": views(ctx), "target": target}


def view_inputs(encoder, capacity_factor, scene, view=0):
    """The compositor's inputs for one target view of ``scene``, from the
    encoder's Gaussians, as the decoder builds them."""
    import torch
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.ops.rendering import preprocess_gaussians

    ctx = {k: torch.from_numpy(np.asarray(a)).to(DEVICE) for k, a in scene["context"].items()}
    tgt = {k: torch.from_numpy(np.asarray(a)).to(DEVICE) for k, a in scene["target"].items()}
    with torch.no_grad():
        g = encoder(ctx)["gaussians"]
        for f in ("means", "covariances", "harmonics", "opacities"):
            x = getattr(g, f)
            if x.shape[:2] != (1, 2 * H * W) or not torch.isfinite(x).all():
                raise AssertionError(f"encoder output {f}: shape {tuple(x.shape)} or non-finite")
        near = tgt["near"][0, view]
        extr = tgt["extrinsics"][0, view].clone()
        extr[:3, 3] = extr[:3, 3] / near  # the decoder's 1/near rescale
        screen = preprocess_gaussians(
            g.means[0] / near, g.covariances[0] / (near * near), g.harmonics[0],
            g.masked_opacities()[0], extr, tgt["intrinsics"][0, view], (H, W), 2,
        )
        binning = R.bin_gaussians(
            screen, (H, W), R.render_capacity(g.means.shape[1], capacity_factor))
        inst = R.build_instance_rows(screen, binning)
    return inst, binning, ctx, tgt


def _count_dicts():
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.scripts import probe_r3

    return R.launch_count, probe_r3.launch_count


def launch_counts() -> dict:
    """Every kernel's launches since the last reset."""
    return {k: v for d in _count_dicts() for k, v in d.items()}


def reset_launch_counts():
    for d in _count_dicts():
        for k in d:
            d[k] = 0


def check_test_outputs(out: Path, summary: dict, launches: dict, views: int, label: str):
    """What ``run_test`` must leave after a run: finite summary values
    with SSIM <= 1, the FVS split and the depth metrics, the stats files
    and each scene's frame folders, and the forward kernel launched once
    per target view, no other kernel."""
    if DEVICE == "cuda" and launches != {"rasterize_fwd": views, "rasterize_bwd": 0,
                                         "gather_rows": 0}:
        raise AssertionError(f"{label} launches {launches} for {views} target views")
    if not all(math.isfinite(v) for v in summary.values()):
        raise AssertionError(f"{label}: non-finite summary {summary}")
    ssim = {k: v for k, v in summary.items() if k == "ssim" or k.endswith("_ssim")}
    if not ssim or max(ssim.values()) > 1.0:
        raise AssertionError(f"{label}: SSIM missing or above 1: {ssim}")
    want = {f"{p}_{m}" for p in ("interpolation", "extrapolation") for m in ("psnr", "ssim", "lpips")}
    want |= {f"depth_{m}" for m in ("abs_diff", "abs_rel", "delta_25", "delta_10")}
    if not want <= set(summary):
        raise AssertionError(f"{label}: summary lacks {sorted(want - set(summary))}")
    if summary["dropped_instances"] != 0:
        raise AssertionError(f"{label}: rasterizer dropped instances: {summary}")
    stats = json.loads((out / "stats.json").read_text())
    files = {f: (out / f).exists() for f in ("benchmark.json", "peak_memory.json")}
    memory = json.loads((out / "peak_memory.json").read_text())
    if not all(files.values()) or (DEVICE == "cuda" and "device_0" not in memory):
        raise AssertionError(f"{label}: stats files {files}, peak memory {list(memory)}")
    for entry in stats["per_scene"]:
        d = out / entry["scene"]
        got = {p.name for p in d.iterdir()}
        color = ({"interpolation", "extrapolation"} if "extrapolation_psnr" in entry
                 else {"color"})
        if got != color | {"context", "depth_pred", "depth_render"}:
            raise AssertionError(f"{label}: {entry['scene']} dumped {sorted(got)}")
        pngs = sum(len(list((d / c).glob("*.png"))) for c in color)
        if pngs != 2 * entry["num_views"]:
            raise AssertionError(f"{label}: {entry['scene']} has {pngs} frame PNGs")


def slice_run():
    """Serving: run_test over 3 scenes with the preset's defaults (PSNR,
    SSIM, LPIPS, rendered-depth metrics, frame and depth dumps, the stats
    files), the second scene an FVS one; then kernels vs plain on one of
    its views, then one profiled warm scene."""
    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.evaluation.harness import run_test
    from freesplat_tpu_torch.models.decoder import render_views
    from freesplat_tpu_torch.models.encoder import make_encoder
    from freesplat_tpu_torch.training.lpips import make_lpips

    scenes = [make_scene(1, depth=True), make_scene(2, depth=True, test_fvs=1),
              make_scene(3, depth=True)]
    views = sum(s["target"]["image"].shape[1] for s in scenes)
    lpips = make_lpips(device=DEVICE, seed=LPIPS_SEED)  # no pretrained weights ship
    timings: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        # Seeded random weights make splats larger than trained ones (~3.6
        # tile instances per Gaussian where the preset's budget allows
        # 3.0), so the test-time budget is raised: the port's binning costs
        # what the instances need, not the budget, so the headroom is free.
        cfg = load_config(["+experiment=scannet/2views", "mode=test", f"test.output_path={out}",
                           "test.render_capacity_factor=8.0"])
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        summary = run_test(cfg, batches=iter(scenes), lpips=lpips, device=DEVICE,
                           timings=timings)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
        check_test_outputs(out, summary, launches, views, "serving")
    if not ("ssim" in summary and "lpips" in summary):
        raise AssertionError(f"serving summary lacks the plain scenes' metrics: {sorted(summary)}")
    split = {k: [round(1e3 * t, 2) for t in timings[k]]
             for k in ("encoder_s", "metrics_s", "dumps_s")}
    split["render_s"] = [round(1e3 * t * v, 2) for t, v in
                         zip(timings["decoder_s_per_view"],
                             (s["target"]["image"].shape[1] for s in scenes))]
    log(f"[slice] scenes 3 (the second with test_fvs 1), target views {views}, wall {wall:.2f} s, "
        f"per-scene ms: encode {split['encoder_s']}, render {split['render_s']}, metrics "
        f"{split['metrics_s']}, dumps {split['dumps_s']}; gaussians/scene "
        f"{summary['num_gaussians']:.0f}, psnr {summary['psnr']:.3f}, ssim {summary['ssim']:.4f}, "
        f"lpips {summary['lpips']:.4f}, depth_abs_rel {summary['depth_abs_rel']:.4f}, "
        f"peak memory {peak} B, launches {launches}")

    # One view of scene 1 through the same encoder weights: kernels vs
    # plain on the main path's own compositor inputs.
    encoder = make_encoder(cfg.encoder, device=DEVICE, seed=cfg.seed)
    inst, binning, ctx, tgt = view_inputs(encoder, cfg.test.render_capacity_factor, scenes[0])
    cmp = compare_tiles(inst, binning, W // 16, seed=2)
    log(f"[slice] view 0 of scene 1: forward max_err {cmp[0]:.3g}, backward max_err "
        f"{cmp[1]:.3g} (scaled {cmp[-1]:.3g})")
    time_kernels(inst, binning, W // 16, cmp, "slice view")
    if DEVICE == "cuda":
        dcfg = dataclasses.replace(cfg.decoder, capacity_factor=cfg.test.render_capacity_factor)

        def one_scene():
            with torch.no_grad():
                g = encoder(ctx)["gaussians"]
                render_views(dcfg, g, tgt["extrinsics"], tgt["intrinsics"], tgt["near"],
                             tgt["far"], (H, W))

        profile_window(one_scene, "one scene (encode + 3 views)")
    return launches, cmp[:2]


def train_run():
    """Training: fit for TRAIN_STEPS full-width steps, then kernels vs
    plain on a target view of the trained Gaussians, and one profiled
    warm step."""
    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.training.lpips import make_lpips
    from freesplat_tpu_torch.training.trainer import TrainCfg, fit, init_state, make_train_step

    # As in serving, seeded random weights need more than the preset's
    # 3.0 instances per Gaussian.
    cfg = load_config(["+experiment=scannet/2views", "mode=train", "decoder.capacity_factor=8.0"])
    tcfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                    optimizer=cfg.optimizer, log_every=1)
    state = init_state(tcfg, seed=cfg.seed, device=DEVICE)
    lpips = make_lpips(device=DEVICE, seed=LPIPS_SEED)
    scenes = [make_scene(10 + i, v_tgt=TRAIN_TARGET_VIEWS) for i in range(TRAIN_STEPS + 1)]
    encoder = state["encoder"]
    params0 = {k: p.detach().clone() for k, p in encoder.named_parameters()}
    buffers0 = {k: b.clone() for k, b in encoder.named_buffers()}
    logged: list = []
    timings: dict = {}
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = fit(tcfg, state, iter(scenes[:TRAIN_STEPS]), TRAIN_STEPS, lpips=lpips,
                log_fn=lambda step, vals: logged.append((step, vals)), timings=timings)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    want = TRAIN_TARGET_VIEWS * TRAIN_STEPS
    if DEVICE == "cuda" and launches != {"rasterize_fwd": want, "rasterize_bwd": want,
                                         "gather_rows": 0}:
        raise AssertionError(f"training launches {launches}, want {want} of each kernel")
    if [s for s, _ in logged] != list(range(TRAIN_STEPS)):
        raise AssertionError(f"fit logged steps {[s for s, _ in logged]}")
    for step, vals in logged:
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step {step}: non-finite metrics {vals}")
        if vals["dropped_instances"] != 0:
            raise AssertionError(f"step {step}: rasterizer dropped instances: {vals}")
        log(f"[train] step {step}: " + " ".join(f"{k}={v:.6g}" for k, v in vals.items()))
    reached = [k for k, p in encoder.named_parameters()
               if p.grad is not None and bool((p.grad != 0).any())]
    stuck = [k for k in reached if torch.equal(params0[k], dict(encoder.named_parameters())[k])]
    if not reached or stuck:
        raise AssertionError(f"parameters the loss reaches that did not move: {stuck[:10]}")
    still = [k for k, b in encoder.named_buffers() if torch.equal(b, buffers0[k])]
    if still:
        raise AssertionError(f"BN running buffers that did not move: {still[:10]}")
    step_ms = [1e3 * sum(x) for x in zip(timings["forward_s"], timings["backward_s"],
                                         timings["optimizer_s"])]
    warm = step_ms[1:]
    split = {k: float(np.median([1e3 * t for t in timings[k][1:]]))
             for k in ("forward_s", "backward_s", "optimizer_s")}
    log(f"[train] {TRAIN_STEPS} steps of {TRAIN_TARGET_VIEWS} target views, wall {wall:.2f} s; "
        f"ms per step {step_ms}; warm median {float(np.median(warm)):.2f} ms "
        f"(forward {split['forward_s']:.2f}, backward {split['backward_s']:.2f}, "
        f"optimizer {split['optimizer_s']:.2f}; each phase ends in a device sync); "
        f"peak memory {peak} B; launches {launches}; "
        f"{len(reached)} of {len(params0)} parameter leaves reached and all moved; "
        f"{len(buffers0)} BN buffers moved")

    inst, binning, _, _ = view_inputs(encoder, tcfg.decoder.capacity_factor, scenes[0])
    cmp = compare_tiles(inst, binning, W // 16, seed=3)
    log(f"[train] target view 0 of the first scene: forward max_err {cmp[0]:.3g}, "
        f"backward max_err {cmp[1]:.3g} (scaled {cmp[-1]:.3g})")
    timing = time_kernels(inst, binning, W // 16, cmp, "train view")
    if DEVICE == "cuda":
        step_fn = make_train_step(tcfg, lpips)
        holder = {"state": state}

        def one_step():
            holder["state"], _ = step_fn(holder["state"], scenes[TRAIN_STEPS])

        saved = dict(R.launch_count)
        profile_window(one_step, f"one warm train step ({TRAIN_TARGET_VIEWS} target views)")
        R.launch_count.update(saved)
    return launches, cmp[:2], timing


def lpips_npz() -> Path:
    """The LPIPS weights of ``LPIPS_SEED`` as a flax-layout .npz under
    ``build/``, for the CLI's ``loss.lpips.weights_path``."""
    from freesplat_tpu_torch.training.lpips import make_lpips, save_lpips_params
    from freesplat_tpu_torch.utils.flax_bridge import torch_to_jax_variables

    path = ROOT / "build" / f"lpips_seed{LPIPS_SEED}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_lpips_params(torch_to_jax_variables(make_lpips(device=DEVICE, seed=LPIPS_SEED)),
                      str(path))
    return path


def train_depth_run():
    """Depth-supervised training: ``fit`` for DEPTH_STEPS full-width steps
    with all four ``loss.depth.*`` terms on (targets with sensor depth and
    holes, 2 context views so the multi-view term runs).  Every depth part
    must be finite and non-zero and each kernel launch 8 times a step.
    The first backward launch of the run is recorded and its own
    cotangent, whose depth channel the depth losses make non-zero, is
    given again to the kernel and to the plain backward."""
    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.training.lpips import make_lpips
    from freesplat_tpu_torch.training.trainer import TrainCfg, fit, init_state

    cfg = load_config(["+experiment=scannet/2views", "mode=train", "decoder.capacity_factor=8.0",
                       *(f"loss.depth.{k}=0.1" for k in DEPTH_WEIGHTS)])
    tcfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                    optimizer=cfg.optimizer, log_every=1)
    state = init_state(tcfg, seed=cfg.seed, device=DEVICE)
    lpips = make_lpips(device=DEVICE, seed=LPIPS_SEED)
    scenes = [make_scene(20 + i, v_tgt=TRAIN_TARGET_VIEWS, depth=True)
              for i in range(DEPTH_STEPS)]
    recorded: list = []
    own_bwd = R.composite_tiles_bwd

    def recording_bwd(*args):
        if not recorded:
            recorded.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return own_bwd(*args)

    logged: list = []
    timings: dict = {}
    reset_launch_counts()
    R.composite_tiles_bwd = recording_bwd
    try:
        t0 = time.perf_counter()
        fit(tcfg, state, iter(scenes), DEPTH_STEPS, lpips=lpips,
            log_fn=lambda step, vals: logged.append((step, vals)), timings=timings)
        sync()
        wall = time.perf_counter() - t0
    finally:
        R.composite_tiles_bwd = own_bwd
    launches = launch_counts()
    want = TRAIN_TARGET_VIEWS * DEPTH_STEPS
    if DEVICE == "cuda" and launches != {"rasterize_fwd": want, "rasterize_bwd": want,
                                         "gather_rows": 0}:
        raise AssertionError(f"depth-supervised launches {launches}, want {want} of each kernel")
    parts = [f"loss_depth_{k}" for k in ("grad", "si", "normals", "mv")]
    if [s for s, _ in logged] != list(range(DEPTH_STEPS)):
        raise AssertionError(f"fit logged steps {[s for s, _ in logged]}")
    for step, vals in logged:
        bad = [k for k in parts if not (math.isfinite(vals.get(k, math.nan)) and vals[k] != 0)]
        if bad or not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"depth step {step}: parts {bad} missing, zero or non-finite: "
                                 f"{vals}")
        if vals["dropped_instances"] != 0:
            raise AssertionError(f"depth step {step}: rasterizer dropped instances: {vals}")
        log(f"[depth] step {step}: " + " ".join(f"{k}={v:.6g}" for k, v in vals.items()))
    step_ms = [1e3 * sum(x) for x in zip(timings["forward_s"], timings["backward_s"],
                                         timings["optimizer_s"])]
    log(f"[depth] {DEPTH_STEPS} steps of {TRAIN_TARGET_VIEWS} target views, all four depth "
        f"terms at 0.1, wall {wall:.2f} s; ms per step {[round(t, 2) for t in step_ms]} "
        f"(forward {[round(1e3 * t, 2) for t in timings['forward_s']]}, backward "
        f"{[round(1e3 * t, 2) for t in timings['backward_s']]}); launches {launches}")

    inst, tile_start, tile_count, tiles_x, out, walk, cot = recorded[0]
    depth_cot = cot[..., 3].abs().max().item()
    if not depth_cot > 0:
        raise AssertionError("the depth-supervised step gave the backward a zero depth cotangent")
    saved = dict(R.launch_count)
    bwd_err, scaled, walked, contributed = check_bwd((inst, tile_start, tile_count, tiles_x),
                                                     out, walk, cot)
    R.launch_count.update(saved)  # a comparison launch, not the main path's
    log(f"[depth] the step's first backward launch, its own cotangent (depth channel max |g| "
        f"{depth_cot:.3g}, color {cot[..., :3].abs().max().item():.3g}): kernel vs plain max "
        f"abs error {bwd_err:.3g} (scaled {scaled:.3g}), {walked} pairs walked, "
        f"{contributed} contributing")
    return launches, bwd_err, step_ms


def write_replica_scene(root: Path, n=16, seed=7) -> Path:
    """A Replica-layout scene at the dataset's native 640x480: JPEG color,
    uint16 millimetre depth PNGs with holes, color and depth intrinsics,
    c2w extrinsics on a short arc; the test index lists the suffixed key
    ``room0_1`` and the evaluation index takes 2 context views, 3
    interpolation and 1 extrapolation target.  Returns the index path."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    scene = root / "test" / "room0"
    for sub in ("color", "depth", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    coarse = rng.uniform(size=(n, 30, 40, 3))
    color = np.repeat(np.repeat(coarse, 16, axis=1), 16, axis=2)
    color = np.clip(color + 0.05 * rng.standard_normal(color.shape), 0, 1)
    depth_mm = (1000 * sensor_depth(rng, n, 480, 640)).astype(np.uint16)
    for i in range(n):
        Image.fromarray((255 * color[i]).astype(np.uint8), "RGB").save(scene / "color" / f"{i}.jpg")
        Image.fromarray(depth_mm[i]).save(scene / "depth" / f"{i}.png")
    k = np.array([[320.0, 0, 319.5, 0], [0, 320, 239.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    np.savetxt(scene / "intrinsic" / "intrinsic_color.txt", k)
    np.savetxt(scene / "intrinsic" / "intrinsic_depth.txt", k)
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, t in enumerate(np.linspace(0.0, 1.0, n)):
        a = 0.15 * t
        extr[i, :3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
        extr[i, :3, 3] = [0.5 * t, 0.0, 0.05 * t]
    np.save(scene / "extrinsics.npy", extr)
    (root / "test_idx.txt").write_text("room0_1\n")
    index = root / "evaluation_index_replica.json"
    index.write_text(json.dumps(
        {"room0_1": {"context": [0, 10], "target": [3, 5, 8], "extrapolation": [13]}}))
    return index


def replica_run():
    """Replica through the CLI: ``main`` with ``+experiment=replica/2views
    mode=test`` (384x512, the preset's defaults, LPIPS weights from
    ``LPIPS_SEED``) on a scene written in the dataset's layout.  The
    stats, dumps and launches are checked as in serving."""
    from freesplat_tpu_torch import main as M

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        index = write_replica_scene(tmp / "replica")
        out = tmp / "out"
        reset_launch_counts()
        t0 = time.perf_counter()
        M.main(["+experiment=replica/2views", "mode=test", f"dataset.roots=[{tmp / 'replica'}]",
                f"dataset.evaluation_index_path={index}", f"test.output_path={out}",
                f"dataset.image_shape=[{H},{W}]", "test.render_capacity_factor=8.0",
                f"loss.lpips.weights_path={lpips_npz()}"],
               device=DEVICE)
        sync()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        stats = json.loads((out / "stats.json").read_text())
        summary = stats["summary"]
        check_test_outputs(out, summary, launches, 4, "replica")
        (entry,) = stats["per_scene"]
        if (entry["scene"], entry["num_views"]) != ("room0_1", 4):
            raise AssertionError(f"replica scene {entry['scene']} with {entry['num_views']} views")
    log(f"[replica] room0_1 (read from room0/) through main: 4 target views (1 extrapolation), "
        f"wall {wall:.2f} s, interpolation psnr {summary['interpolation_psnr']:.3f} ssim "
        f"{summary['interpolation_ssim']:.4f}, extrapolation psnr "
        f"{summary['extrapolation_psnr']:.3f}, depth_abs_rel {summary['depth_abs_rel']:.4f}, "
        f"launches {launches}")
    return launches


def _gather_check(label, x, idx):
    """The gather kernel vs its plain version on one input: equal, NaN in
    the same places, the kernel launched once.  Returns the max abs
    error."""
    import torch
    from freesplat_tpu_torch.scripts import probe_r3 as P

    before = P.launch_count["gather_rows"]
    k, p = P.gather_rows(x, idx), P.gather_rows_plain(x, idx)
    sync()
    nan = torch.isnan(p)
    d = (k[~nan] - p[~nan]).abs().max().item() if bool((~nan).any()) else 0.0
    if not (torch.equal(torch.isnan(k), nan) and d == 0.0):
        raise AssertionError(f"gather_rows {label} vs plain: NaN places differ or max abs "
                             f"error {d}")
    if DEVICE == "cuda" and P.launch_count["gather_rows"] != before + 1:
        raise AssertionError(f"gather_rows {label}: the kernel was not launched")
    return d


def _baseline_gather():
    """``BASELINE/gather_rows.cu``'s kernel as a function of (x, idx),
    bound with the C signature (x, idx, rows, lanes, out, stream)."""
    import torch

    fn = _baseline_fn("gather_rows")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.restype, fn.argtypes = i32, [ptr, ptr, i32, i32, ptr, ptr]

    def gather(x, idx):
        out = torch.empty_like(x)
        rc = fn(x.data_ptr(), idx.data_ptr(), x.shape[0], x.shape[1], out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline gather_rows launch failed: cudaError {rc}")
        return out

    return gather


def gather_phase():
    """The gather kernel vs its plain version (exactly: a gather does no
    arithmetic) at the probe shapes and on wrapped and out-of-range
    indices; then the device time at the largest shape of the kernel, the
    plain version and ``torch.gather``, with the bound (and with
    ``BASELINE`` set, the baseline's kernel in turns).  Returns (max abs
    error, (ms, plain ms, library ms, bound ms, bound by))."""
    import torch
    from freesplat_tpu_torch.scripts import probe_r3 as P
    from freesplat_tpu_torch.utils.timing import device_bench

    err = 0.0
    for rows, lanes in P.GATHER_SHAPES:
        x_np, idx_np = P.gather_inputs(rows, lanes)
        x, idx = torch.from_numpy(x_np).to(DEVICE), torch.from_numpy(idx_np).to(DEVICE)
        err = max(err, _gather_check(f"({rows},{lanes})", x, idx))
    rng = np.random.default_rng(4)

    def wrapped(rows, lanes, offset=0):
        """x from the seed, at ``offset`` floats into its buffer; idx over
        [-2 rows, 2 rows): in range, wrapped and out of range."""
        buf = torch.from_numpy(rng.standard_normal(rows * lanes + offset).astype(np.float32))
        x = buf.to(DEVICE)[offset:].view(rows, lanes)
        idx = rng.integers(-2 * rows, 2 * rows, (rows, lanes)).astype(np.int32)
        return x, torch.from_numpy(idx).to(DEVICE)

    cases = (("(640,96)", wrapped(640, 96)),
             ("(12416,192)", wrapped(12416, 192)),
             ("lanes % 4 != 0 (12416,190)", wrapped(12416, 190)),
             ("16,384 rows (16384,128)", wrapped(16384, 128)),
             ("x at a 4 B offset (12416,192)", wrapped(12416, 192, offset=1)))
    for label, (x, idx) in cases:
        err = max(err, _gather_check(f"wrap/out of range {label}", x, idx))
    log(f"[gather] {len(P.GATHER_SHAPES)} probe shapes and {len(cases)} wrap/NaN cases "
        f"({'; '.join(c[0] for c in cases)}) equal the plain version (max abs error {err})")

    rows, lanes = P.GATHER_SHAPES[-1]
    x_np, idx_np = P.gather_inputs(rows, lanes)
    x, idx = torch.from_numpy(x_np).to(DEVICE), torch.from_numpy(idx_np).to(DEVICE)
    idx64 = idx.long()  # torch.gather's index type, made outside the timed call
    fns = {"kernel": (P.gather_rows, idx), "plain": (P.gather_rows_plain, idx),
           "torch.gather": (lambda a, i: torch.gather(a, 0, i), idx64)}
    # Device time of back-to-back calls of one (x, idx): the 28.6 MB of
    # table, index and output stay in the 50 MB L2 between calls, as in the
    # probe's loop.
    dev = {k: device_bench(f, [(x, i)], n=50) * 1e3 for k, (f, i) in fns.items()}
    el = rows * lanes
    bound = _bound(el * GATHER_BYTES_PER_ELEM, el * GATHER_OPS_PER_ELEM)
    log(f"[gather] ({rows},{lanes}) device ms per call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in dev.items())
        + f"; bound {bound[0]:.4f} ms ({bound[1]}; {el * GATHER_BYTES_PER_ELEM} B)")
    if BASELINE is not None:
        base = _baseline_gather()
        if not torch.equal(base(x, idx), P.gather_rows(x, idx)):
            raise AssertionError("baseline gather_rows differs from this tree's")
        turns = [device_bench(base if b else P.gather_rows, [(x, idx)], n=50) * 1e3
                 for b in (True, False, False, True)]
        log(f"[time]   gather_rows ({rows},{lanes}) baseline vs this tree, device ms in turns "
            f"(baseline, this, this, baseline): {', '.join(f'{t:.4f}' for t in turns)}")
    return err, (dev["kernel"], dev["plain"], dev["torch.gather"], *bound)


def probe_run():
    """``scripts/probe_r3.main(["all"])`` in-process, as a user runs it.
    Returns its launches and results."""
    from freesplat_tpu_torch.scripts import probe_r3

    reset_launch_counts()
    results = probe_r3.main(["all"], device=DEVICE)
    launches = launch_counts()
    if DEVICE == "cuda" and not all(launches.values()):
        raise AssertionError(f"probe path launches {launches}: a kernel was not launched")
    r = results["raster"]
    if not (r["color_max_abs"] <= TOL_COLOR and r["grad_rel"] <= TOL_GRAD):
        raise AssertionError(f"probe raster kernel vs plain: {r}")
    log(f"[probe] launches {launches}")
    return launches, results


class _Tee(io.TextIOBase):
    """Standard output that is also kept, to read what ``main`` printed."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def cli_run():
    """``main`` trains CLI_STEPS steps on the synthetic stream (checkpoint
    at step 2, validation at step 3) in a temporary directory, then a
    second ``main`` resumes from the checkpoint.  Launches are split by
    path: data renders (each batch drawn), validation renders and the
    train steps (the rest)."""
    import torch
    from freesplat_tpu_torch import main as M
    from freesplat_tpu_torch.training import checkpoint as C
    from freesplat_tpu_torch.training import validation as V

    lpips_path = lpips_npz()
    by_path = {"cli_data": {}, "cli_train": {}, "cli_val": {}}
    draws, vals, restored = [0], [0], []

    def add(path, before):
        now = launch_counts()
        for k in now:
            by_path[path][k] = by_path[path].get(k, 0) + now[k] - before[k]

    orig_batches, orig_val, orig_restore = M.make_batches, V.validation_step, M.restore_checkpoint

    def counted_batches(*a, **kw):
        it = orig_batches(*a, **kw)

        def gen():
            while True:
                before = launch_counts()
                batch = next(it, None)
                add("cli_data", before)
                if batch is None:
                    return
                draws[0] += 1
                yield batch

        return gen()

    def counted_val(*a, **kw):
        before = launch_counts()
        out = orig_val(*a, **kw)
        add("cli_val", before)
        vals[0] += 1
        return out

    def checked_restore(directory, step, state, strict=True):
        state = orig_restore(directory, step, state, strict)
        saved = C.load_checkpoint(directory, step, "cpu")
        for k, v in state["encoder"].state_dict().items():
            if not torch.equal(v.cpu(), saved["encoder"][k]):
                raise AssertionError(f"restored {k} differs from the checkpoint")
        opt = state["optimizer"].state_dict()["state"]
        for i, s in saved["optimizer"]["state"].items():
            for k, v in s.items():
                if not torch.equal(opt[i][k].cpu(), v):
                    raise AssertionError(f"restored Adam {k} of parameter {i} differs")
        restored.append((step, state["step"], len(saved["encoder"]), len(opt)))
        return state

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        args = ["+experiment=scannet/2views", "dataset.name=synthetic",
                "dataset.synthetic_renderer=tile", "dataset.synthetic_num_targets=8",
                "decoder.capacity_factor=8.0", f"dataset.image_shape=[{H},{W}]",
                f"trainer.max_steps={CLI_STEPS}", "checkpointing.every_n_train_steps=2",
                "trainer.val_check_interval=3", "trainer.log_every=1",
                f"loss.lpips.weights_path={lpips_path}"]
        cwd = os.getcwd()
        os.chdir(tmp)  # the logger and validation write under outputs/local
        M.make_batches, V.validation_step, M.restore_checkpoint = (
            counted_batches, counted_val, checked_restore)
        try:
            runs = []
            for extra, steps in (([f"checkpointing.output_dir={tmp / 'ckpt'}"], CLI_STEPS),
                                 ([f"checkpointing.load={tmp / 'ckpt'}",
                                   f"checkpointing.output_dir={tmp / 'ckpt2'}"], 1)):
                reset_launch_counts()
                draws[0] = vals[0] = 0
                for p in by_path.values():
                    p.clear()
                tee = _Tee(sys.stdout)
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(tee):
                    M.main(args + extra, device=DEVICE)
                sync()
                wall = time.perf_counter() - t0
                total = launch_counts()
                for k in total:
                    by_path["cli_train"][k] = (total[k] - by_path["cli_data"].get(k, 0)
                                               - by_path["cli_val"].get(k, 0))
                runs.append((steps, draws[0], vals[0], {p: dict(v) for p, v in by_path.items()},
                             tee.buf.getvalue(), wall))
        finally:
            M.make_batches, V.validation_step, M.restore_checkpoint = (
                orig_batches, orig_val, orig_restore)
            os.chdir(cwd)
        metrics = [json.loads(line)
                   for line in (tmp / "outputs/local/metrics.jsonl").read_text().splitlines()]
        files_ok = {
            "step_2": (tmp / "ckpt" / "step_2" / "state.pt").exists(),
            "val png": (tmp / "outputs/local/val_0000003.png").exists(),
            "val_metrics.txt": (tmp / "outputs/local/val_metrics.txt").exists(),
        }
    if not all(files_ok.values()):
        raise AssertionError(f"CLI outputs missing: {files_ok}")
    if not restored or restored[0][:2] != (2, 3):
        raise AssertionError(f"resume restored {restored}, want step_2 holding state step 3")
    if "restored checkpoint step 2" not in runs[1][4]:
        raise AssertionError("the resumed run did not print 'restored checkpoint step 2'")
    views = 2 + 8  # context + target views rendered for each batch drawn
    for steps, n_draws, n_vals, paths, _, _ in runs:
        want = {
            "cli_data": {"rasterize_fwd": views * n_draws, "rasterize_bwd": 0},
            "cli_train": {"rasterize_fwd": 8 * steps, "rasterize_bwd": 8 * steps},
            "cli_val": {"rasterize_fwd": 8 * n_vals, "rasterize_bwd": 0},
        }
        got = {p: {k: v.get(k, 0) for k in ("rasterize_fwd", "rasterize_bwd")}
               for p, v in paths.items()}
        if DEVICE == "cuda" and (got != want or n_vals != 1):
            raise AssertionError(f"CLI launches {got}, want {want} ({n_draws} batches drawn, "
                                 f"{n_vals} validations)")
    if [m["step"] for m in metrics] != [*range(CLI_STEPS), CLI_STEPS - 1]:
        raise AssertionError(f"CLI logged steps {[m['step'] for m in metrics]}")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()) or m["dropped_instances"] != 0:
            raise AssertionError(f"CLI step {m['step']}: {m}")
    step_ms = [1e3 / m["steps_per_s"] for m in metrics]
    log(f"[cli] {CLI_STEPS} steps then 1 resumed, walls {runs[0][5]:.2f} s and {runs[1][5]:.2f} s; "
        f"ms per logged step (data draw + step; step 3 also the step-2 checkpoint) "
        f"{[round(t, 2) for t in step_ms]}; loss {[round(m['loss'], 5) for m in metrics]}; "
        f"restored {restored[0][2]} tensors and {restored[0][3]} Adam states; launches "
        f"{runs[0][3]} then {runs[1][3]}")
    total = {}
    for run in runs:
        for p, counts in run[3].items():
            for k, v in counts.items():
                total.setdefault(p, {}).setdefault(k, 0)
                total[p][k] += v
    return total, step_ms


def profile_window(fn, label):
    """torch.profiler over one warm call of ``fn``: the device's busy share
    of the host wall time and the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from freesplat_tpu_torch.ops import rasterizer as R

    saved = dict(R.launch_count)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    R.launch_count.update(saved)
    # Device activity only (kernels, copies, sets): one stream, no overlap.
    kernels: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(sum(v) for v in kernels.values())
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}")
    for name, v in sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[profile]   {sum(v):9.3f} ms  x{len(v):<5d} {name[:90]}")


def main(argv=None) -> int:
    global BASELINE
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on an NVIDIA GPU.")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a directory holding another tree's rasterize_{fwd,bwd}.cu and "
                         "gather_rows.cu, held against this tree's kernels and timed "
                         "beside them")
    BASELINE = ap.parse_args(argv).baseline
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
    names = ["rasterize_fwd", "rasterize_bwd", "gather_rows"]
    cuda_build.build_all(names)
    log(f"[build] {names} in {time.perf_counter() - t0:.2f} s")
    for k in names:
        log(f"[build] {k}: {cuda_build.BUILD_INFO[k]['log']}")

    errs = [kernel_cases()]
    bench_err, bench_t = bench_scene()
    errs.append(bench_err)
    serve_launches, serve_err = slice_run()
    errs.append(serve_err)
    train_launches, train_err, timing = train_run()
    errs.append(train_err)
    depth_launches, depth_bwd_err, _ = train_depth_run()
    errs.append((0.0, depth_bwd_err))
    replica_launches = replica_run()
    gather_err, gather_t = gather_phase()
    probe_launches, probe = probe_run()
    cli_launches, _ = cli_run()
    for k, (ms, plain_ms, bound_ms, bound_by) in bench_t.items():
        log(f"[bench] {k} at the bench scene: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")

    paths = {"serve": serve_launches, "train": train_launches, "train_depth": depth_launches,
             "replica": replica_launches, "probe": probe_launches, **cli_launches}
    rows = []
    for i, (name, line) in enumerate((("rasterize_fwd", 378), ("rasterize_bwd", 457))):
        ms, plain_ms, bound_ms, bound_by = timing[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"freesplat_tpu_torch/csrc/{name}.cu",
            "replaces": f"freesplat_tpu/ops/rasterizer.py:{line}",
            "launches": train_launches[name],
            "launches_by_path": {p: c.get(name, 0) for p, c in paths.items()},
            "max_abs_err": max(e[i] for e in errs),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    ms, plain_ms, lib_ms, bound_ms, bound_by = gather_t
    rows.append({
        "name": "gather_rows",
        "route": "cuda",
        "source": "freesplat_tpu_torch/csrc/gather_rows.cu",
        "replaces": "freesplat_tpu/scripts/probe_r3.py:31",
        "launches": probe_launches["gather_rows"],
        "launches_by_path": {p: c.get("gather_rows", 0) for p, c in paths.items()},
        "max_abs_err": max(gather_err, *(r["max_abs_err"] for r in probe["gather"])),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
