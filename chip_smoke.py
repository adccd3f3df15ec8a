"""Drive the PyTorch port on an NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card (nvidia-smi name and power
   limit), the torch/CUDA versions and the TF32 flags.
2. Builds every CUDA kernel from ``freesplat_tpu_torch/csrc/`` into
   ``build/kernels/`` (one nvcc per source, in parallel) and prints each
   ptxas report.
3. Kernels vs their plain PyTorch versions on the card: the rasterizer
   test cases at their small sizes, then the 384x512 bench scene
   (n = 393,216, seed 0, sh_degree 2).  Forward: color/alpha atol 2e-5,
   depth atol 2e-4, the ``walk`` residual exactly, equal dropped /
   num_instances against the CPU binning.  Backward (numpy-seeded
   cotangents): every dinst column within 2e-4 after scaling by the
   column's largest magnitude.
4. Serving: the ``scannet/2views`` preset (384x512, 2 context views,
   D = 128, fp32) with weights from a seed serves 3 numpy-made scenes of
   3 target views through ``run_test``.  The forward's launch count must
   equal the views rendered, the backward's stay 0; outputs finite;
   nothing dropped.  One rendered view is held against the plain
   compositor, and one warm scene is profiled.
5. Training: ``+experiment=scannet/2views mode=train
   decoder.capacity_factor=8.0`` (8 target views, MSE + 0.05 LPIPS with
   LPIPS weights from a seed) runs ``fit`` for 5 steps.  Each kernel must
   launch 8 times per step; metrics finite; nothing dropped; every
   parameter the loss reaches and every BN running buffer moved.  Prints
   ms per step and its forward / backward / optimizer split, peak memory
   and one profiled warm step; then both kernels are held against their
   plain versions on a target view of the trained Gaussians and timed.
6. Prints the kernel table as one JSON line, the card line, and last
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
    inputs (numpy-seeded cotangent).  Returns (forward max abs error,
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
    rgb = (k[..., 0:3] - p[..., 0:3]).abs().max().item() if k.numel() else 0.0
    alpha = (torch.exp(k[..., 4]) - torch.exp(p[..., 4])).abs().max().item() if k.numel() else 0.0
    depth = (k[..., 3] - p[..., 3]).abs().max().item() if k.numel() else 0.0
    if not (rgb <= TOL_COLOR and alpha <= TOL_COLOR and depth <= TOL_DEPTH):
        raise AssertionError(f"forward kernel vs plain: color {rgb} alpha {alpha} depth {depth}")
    if not torch.equal(k_walk, p_walk):
        raise AssertionError(f"forward kernel vs plain: walk residual differs at "
                             f"{int((k_walk != p_walk).sum())} pixels")
    rng = np.random.default_rng(seed)
    cot = torch.from_numpy(rng.standard_normal(tuple(k.shape)).astype(np.float32)).to(k.device)
    with torch.no_grad():
        dk = R.composite_tiles_bwd(*args, k, k_walk, cot)
        dp, walked, contributed = R.composite_tiles_plain_bwd(*args, p, p_walk, cot,
                                                              count_pairs=True)
    sync()
    bwd_err, scaled = 0.0, 0.0
    if dk.numel():
        diff = (dk - dp).abs().max(0).values
        scaled = (diff / dp.abs().max(0).values.clamp(min=1e-30)).max().item()
        bwd_err = diff.max().item()
    if not (scaled <= TOL_GRAD and bool(torch.isfinite(dk).all())):
        raise AssertionError(f"backward kernel vs plain: scaled error {scaled}, abs {bwd_err}")
    return max(rgb, alpha, depth), bwd_err, pairs, (walked, contributed), (k, k_walk), cot, scaled


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


def time_kernels(inst, binning, tiles_x, cmp, label):
    """Kernel and plain times (CUDA events) and the bound of each kernel,
    for one input, from ``compare_tiles``' results ``cmp``."""
    from freesplat_tpu_torch.ops import rasterizer as R

    _, _, pairs, (walked, contributed), (out, walk), cot, _ = cmp
    args = (inst, binning.tile_start, binning.tile_count, tiles_x)
    saved = dict(R.launch_count)
    fwd = (cuda_ms(lambda: R.composite_tiles_fwd(*args), reps=20),
           cuda_ms(lambda: R.composite_tiles_plain(*args), reps=1))
    bwd = (cuda_ms(lambda: R.composite_tiles_bwd(*args, out, walk, cot), reps=20),
           cuda_ms(lambda: R.composite_tiles_plain_bwd(*args, out, walk, cot), reps=1))
    R.launch_count.update(saved)  # timing launches are not the main path's
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
    log(f"[time] {label}: instances {k}, dropped {int(binning.dropped)}")
    log(f"[time]   forward: kernel {fwd[0]:.4f} ms, plain {fwd[1]:.2f} ms, bound "
        f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}; {fwd_bytes} B, {evaluated} pixel-instance "
        f"pairs evaluated, {blended} blended, {stopped} terminating)")
    log(f"[time]   backward: kernel {bwd[0]:.4f} ms, plain {bwd[1]:.2f} ms, bound "
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


def reset_launch_counts():
    from freesplat_tpu_torch.ops import rasterizer as R

    for k in R.launch_count:
        R.launch_count[k] = 0


def slice_run():
    """Serving: run_test over 3 scenes, then kernels vs plain on one of its
    views, then one profiled warm scene."""
    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.evaluation.harness import run_test
    from freesplat_tpu_torch.models.decoder import render_views
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
    reset_launch_counts()
    t0 = time.perf_counter()
    summary = run_test(cfg, batches=iter(scenes), device=DEVICE, timings=timings)
    wall = time.perf_counter() - t0
    launches = dict(R.launch_count)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    if DEVICE == "cuda" and launches != {"rasterize_fwd": views, "rasterize_bwd": 0}:
        raise AssertionError(f"serving launches {launches} for {views} target views")
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
    lpips = make_lpips(device=DEVICE, seed=cfg.seed + 1)  # no pretrained weights ship
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
    launches = dict(R.launch_count)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    want = TRAIN_TARGET_VIEWS * TRAIN_STEPS
    if DEVICE == "cuda" and launches != {"rasterize_fwd": want, "rasterize_bwd": want}:
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
    names = ["rasterize_fwd", "rasterize_bwd"]
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
    for k, (ms, plain_ms, bound_ms, bound_by) in bench_t.items():
        log(f"[bench] {k} at the bench scene: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")

    rows = []
    for i, (name, line) in enumerate((("rasterize_fwd", 378), ("rasterize_bwd", 457))):
        ms, plain_ms, bound_ms, bound_by = timing[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"freesplat_tpu_torch/csrc/{name}.cu",
            "replaces": f"freesplat_tpu/ops/rasterizer.py:{line}",
            "launches": train_launches[name],
            "launches_by_path": {"serve": serve_launches[name], "train": train_launches[name]},
            "max_abs_err": max(e[i] for e in errs),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
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
