"""Drive the PyTorch port on an NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--baseline DIR]
    python3 chip_smoke.py --proof overfit [--steps 5000] [--keep DIR]
    python3 chip_smoke.py --proof generalization [--steps N] [--scenes 20] [--keep DIR]

Each phase prints ``[phase] <name> start`` and ``[phase] <name> ok
<seconds>``; a phase that raises prints ``[fail] <name>: <type>:
<message>`` and the traceback's last frame, and the run exits non-zero.
``--proof`` runs one quality proof at its published size instead of the
checks (``proof_overfit``, ``proof_generalization``): the curve beside
the JAX package's (``docs/evidence/``), the gates the smoke phases hold
(``check_overfit``, ``check_generalization``) and the scripts' bars, and
with ``--keep`` the curve and stats files copied into DIR.

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
   ``[plane_sweep]``: the fused plane sweep (``csrc/plane_sweep.cu``)
   against ``CostVolume``'s plane-chunk loop on the card at the
   whole-scene chunk (15 views x 4 sources) and the 2-view shape (2 x 1),
   96x128, c = 48, D = 128 over 0.5-15 m, heads from a seed: max |fused -
   loop| over max |loop| within SWEEP_TOL (the share of bit-equal rows
   printed), two calls bit-equal, one launch a call; samples off the map on every side and behind their
   source are counted, and views whose every source is behind read the
   head of 0 at every row (the 1e-8 denominator).  Device ms of both and
   the bound.
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
9. Whole scene (``scripts/whole_scene_bench.py``'s config through
   ``run_test``): 2 synthetic scenes of 30 context and 4 target views at
   384x512, D = 128, nearest-5 sources, 15 views a trunk chunk, render
   capacity factor 1.0, in float32 and then in bfloat16
   (``encoder.compute_dtype``): per scene the phase split (A match,
   geometry, B trunk per chunk, C1 PTF, C2 head), render ms a view,
   num_gaussians, gs_ratio, dropped and the peak memory; one forward
   launch a target view, one plane sweep a trunk chunk in float32 and
   none in bfloat16; bfloat16's warm encode beside float32's.  The
   witness: the first 5 views of the first scene encoded again on the
   card and, with the same weights, on the host CPU, in both dtypes;
   ``depth_s-1`` held within WITNESS_LIMITS (card against host, bfloat16
   against float32).  The forward kernel
   bit-equal to plain on a whole-scene view, with its time, bound and
   tile counts.
10. ``main +experiment=scannet/fvt mode=test`` on a ScanNet-layout scene
   of the 10-view evaluation index (10 context views, 5 a chunk), checked
   as serving is; 2 ``fit`` steps of the ``scannet/fvt`` preset on
   8-context synthetic scenes with every kernel's launches checked.
11. Determinism: two seeded ``fit`` runs of 3 steps give bit-equal
   losses and parameters, and ``fit`` leaves cuDNN's flags as it found
   them; warm steps in four arms in turns, the gathers' backward
   (``ops/gather.py::take_rows`` or ``index_select``) crossed with cuDNN
   free or deterministic; the
   ``segment_sum`` kernel bit-equal to its plain version on one step's
   launches, timed beside it and ``index_add_``.
12. The native frame decoder (``[native]``, right after the kernel
   cases, before any ScanNet-layout scene is read): built from
   ``freesplat_tpu_torch/native/dataloader.cpp`` into ``build/native/``,
   or ``pil`` with the build's error and whether g++, ``jpeglib.h`` and
   ``png.h`` are there; when it built, a 1296x968 JPEG decoded to
   640x480 against PIL's LANCZOS (max 6/255, mean 0.5/255) and the host
   ms a frame of the decoder and of PIL.  RealEstate10K (after Replica):
   chunks of 360x640 JPEGs rendered by the tile rasterizer (3 train
   scenes of 64 frames; the first scene of the 2-view evaluation index
   with its 134 frames), then ``main +experiment=re10k/2views`` trains 4
   steps at 256x256, D = 128 (checkpoint at step 2, a validation at step
   3 with ``trainer.val_save_video=true``) and resumes for one
   (``[re10k_train]``: launches by path, ``dropped`` 0 on every render,
   both GIFs of 30 frames, the warm step's split and peak memory; the
   forward kernel bit-equal to plain and the backward within 2e-4 scaled
   on the first train launches, timed there; the segment sums of the
   first train step bit-equal to plain), and ``mode=test`` with
   ``test.save_ply=true test.save_video=true`` (``[re10k_test]``: finite
   PSNR, SSIM, LPIPS, ``dropped`` 0, the PLY's vertices equal to the
   valid Gaussians, both GIFs, 3 + 60 forward launches, the time split;
   the forward kernel bit-equal to plain at a target view and a wobble
   frame).
13. Weights and validation's extras.  ``[weights]`` (after serving): a
   timm-layout .pth drawn from the 774-key manifest
   (``tests/fixtures/``) and an ``lpips``-layout .pth through
   ``python -m freesplat_tpu_torch.scripts.convert_weights verify`` (exit
   0, finite report); the converted backbone grafted into a
   ``scannet/2views`` encoder (``load_backbone_npz``) serves one scene
   through ``run_test`` twice, with LPIPS from the .npz and from the .pth
   (equal LPIPS); a strict conversion refuses an extra key.
   ``[lpips_leg]`` (after the depth-supervised steps):
   ``scripts/lpips_leg.py --steps 3 --image-shape 384,512`` (4 steps,
   MSE + 0.05 LPIPS from step 0): launches by path, ``loss_lpips`` on
   every step, the warm step's split, the peak bytes; the backward kernel
   within 2e-4 scaled on the first backward launch's own cotangent.
   ``[projections]`` (after the CLI): ``main +experiment=scannet/2views``
   for 2 steps with ``trainer.val_save_projections=true`` and a
   validation: the five panel PNGs, the validation's and each panel's
   ms, launches by path (8 + 3 forwards in the validation); at the first
   orthographic projection view (256x256, fov 10 degrees) the instances
   and ``dropped`` at the default capacity, the forward kernel bit-equal
   to plain, its device time beside its bound.
14. Multi-device (``[multi]``, after the CLI): a child launched by
   ``torchrun --standalone --nproc_per_node 1`` (a world-1 NCCL group;
   ``multi_worker``) trains 3 CLI steps of 8 targets with no group
   (``FREESPLAT_DISTRIBUTED=0``) and then with ``trainer.devices=auto``:
   every logged metric bit-equal.  At the 384x512 train view of a seeded
   encoder's Gaussians, ``render_slab`` for the 4 ranks of a 4-way split:
   assembled bit-equal to ``rasterize`` (color, depth, alpha), nothing
   dropped; the world-1 ``rasterize_sharded`` bit-equal to ``rasterize``
   in value and gradient; at slab 3 (``col_offset`` 24) the forward
   kernel bit-equal to plain and the backward within 2e-4 scaled, both
   timed beside the whole view with their bounds.  ``encode_whole_scene``
   + ``render_whole_scene`` on a 30-view synthetic scene against
   ``make_chunked_encode`` + ``render_views``: masks equal, means, color
   and depth within 1e-4 (bit-equal expected).  ``scaling_bench`` at
   world size 1.  Launches by path: ``multi_data``, ``multi_train``,
   ``multi_val``, ``sharded_render``, ``whole_scene_sharded``.
15. Quality proofs at smoke depth.  ``[overfit]``:
   ``scripts/overfit_proof.py --steps 200 --val-every 100`` at 384x512 in
   a temporary directory: every logged metric finite and nothing dropped
   at any logged step, the train PSNR at step 200 at least 30 dB, the
   test summary with the JAX evidence's keys (and ``dropped_instances``),
   gs_ratio < 1; launches by path
   ``overfit_data``/``overfit_train``/``overfit_val``/``overfit_test``;
   at a target view of the step-200 Gaussians the forward kernel
   bit-equal to plain and the backward within 2e-4 scaled.
   ``[generalization]``: ``scripts/generalization_proof.py train --steps
   100`` at 192x256, then ``eval --scenes 3``: every leg finite, the
   report in the JAX evidence's structure, ``nearest_context`` within
   1e-4 of a float64 numpy recomputation on the host (pose distances,
   PSNR and a Gaussian-window SSIM); launches by path ``gen_data``,
   ``gen_train``, ``gen_eval``.
16. ``[profile]``: ``scripts/whole_scene_profile.py`` at 30 views x
   384x512 in chunks of 15, a cold rep and a warm one inside
   ``utils/profiling.trace`` (the phases, the device's busy share and the
   ten device operations with the most time; the trace file written);
   ``scripts/profile_stages.py raster raster_sub train`` and
   ``scripts/bench_suite.py raster encoder train2`` (lines relayed).
   Launches by path ``profile_ws``, ``profile_stages``, ``bench_suite``.
17. ``[offline]``: ``scripts/compute_metrics.py`` over the serving
   phase's PNG dumps (each scene's PSNR and SSIM within 1e-4 of
   ``compute_psnr``/``compute_ssim`` on the host over the PNGs read back,
   ``run_test``'s unquantized numbers beside); ``scripts/
   generate_evaluation_index.py`` on the ScanNet-layout scene of phase 10
   (poses on a turning track), the same JSON on the card and the host;
   ``videoize_index``; ``scripts/test_splatter.py`` (24 PNGs and a GIF).
18. Prints the kernel table as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""
from __future__ import annotations

import argparse
import collections
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
# Plane sweep, counted from csrc/plane_sweep.cu: a (pixel, plane, source)
# sample projects its point, weighs and tests its four taps (50
# operations), and per channel weighs and adds the taps, takes the dot and
# adds the view sum (10); a (pixel, plane) row divides its c + 1 averages
# and runs the head: 2 (c + 1) 32 + 2 x 32 x 32 + 2 x 32 for the
# multiply-adds, 5 x 32 + 1 for biases and activations.
SWEEP_OPS_PER_SAMPLE, SWEEP_OPS_PER_SAMPLE_CHANNEL = 50, 10
# The fused volume against the plane-chunk loop on the card: max |fused -
# loop| over max |loop|, fixed before the kernel's first run.  Both are
# float32 and the kernel adds in the loop's order (the share of bit-equal
# rows is printed); a head summed in another order read ~2e-7, a count of
# sources off by one (a dot that rounds to 0 in one order only) 0.05, and
# a wrong tap, weight or layout moves the volume by its scale.
SWEEP_TOL = 1e-4
CLI_STEPS = 4
DEPTH_STEPS = 2  # depth-supervised fit steps
WS_VIEWS, WS_TARGETS = 30, 4  # whole scene: context and target views
WS_DEPTH = 128  # whole scene: depth planes
# The card against the host CPU on shared weights (``encode_witness``):
# depth_s-1's relative L2 over the witness's views.  Read on an H100 over
# all 30 views of the scene (PERF.md section 6): card against host 1.40e-3 in float32 (another
# seed's weights: 0.383) and 0.0676 in bfloat16; bfloat16 against float32
# 0.108 on the card, 0.106 on the host, and 0.46 to 0.62 with a bfloat16
# path broken in the package (running BN statistics, planes reversed).
# Faults that move bfloat16 less (softmax or BN statistics in bfloat16:
# 0.108 and 0.110) are held against JAX by tests/test_torch_whole_scene.py.
WITNESS_LIMITS = {"card_vs_host_f32": 1e-2, "card_vs_host_bf16": 0.2, "card_bf16_vs_f32": 0.15}
# The witness encodes this many of the whole scene's views (one trunk
# chunk) on the host: host encodes of all 30 views took 216 and 278 s on
# the H100's host, of 10 views 60 and 80 s (PERF.md section 6), too much
# of the call's time once the quality proofs joined it.
WITNESS_VIEWS = 5
FVT_STEPS = 2  # scannet/fvt fit steps
DET_STEPS = 3  # steps of each seeded fit in the determinism check
DET_TURNS = 2  # rounds of the four timed arms, each forward then backward
DEPTH_WEIGHTS = ("ms_gradient_weight", "scale_invariant_weight", "normals_weight",
                 "mv_consistency_weight")
LPIPS_SEED = 111124  # the training LPIPS's seed (cfg.seed + 1): no pretrained weights ship
VIEW_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")
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
    """ms a call of ``fn``: CUDA events around ``reps`` calls after a warm
    one; the host clock in a CPU rehearsal (``DEVICE = "cpu"``)."""
    import torch

    fn()  # warm up
    if DEVICE != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
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


def compare_tiles(inst, binning, tiles_x, seed=0, col_offset=0):
    """Forward and backward kernels vs their plain versions on the same
    inputs (numpy-seeded cotangent): the forward bit-equal, the backward
    within TOL_GRAD scaled.  Returns (forward max abs error,
    backward max abs error, forward (evaluated, blended, stopped) pairs,
    backward (walked, contributing) pairs, the kernel forward's (out, walk), the cotangent, and the
    backward's largest error after scaling by each column's max).
    ``col_offset``: the tiles' first image column (a slab)."""
    import torch

    args = (inst, binning.tile_start, binning.tile_count, tiles_x)
    err, pairs, (k, k_walk), _ = compare_forward(args, col_offset)
    rng = np.random.default_rng(seed)
    cot = torch.from_numpy(rng.standard_normal(tuple(k.shape)).astype(np.float32)).to(k.device)
    bwd_err, scaled, walked, contributed = check_bwd(args, k, k_walk, cot, col_offset)
    return err, bwd_err, pairs, (walked, contributed), (k, k_walk), cot, scaled


def compare_forward(args, col_offset=0):
    """The forward kernel vs its plain version on one input, bit-equal
    (color, depth, log T and the ``walk`` residual).  Returns (max abs
    error, (evaluated, blended, stopped) pairs, the kernel's (out, walk),
    the plain version's ms)."""
    import torch
    from freesplat_tpu_torch.ops import rasterizer as R

    with torch.no_grad():
        k, k_walk = R.composite_tiles_fwd(*args, col_offset=col_offset)
        sync()
        t0 = time.perf_counter()
        p, p_walk, pairs = R.composite_tiles_plain(*args, count_pairs=True,
                                                   col_offset=col_offset)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
    rgb, depth, log_t = ((k[..., c] - p[..., c]).abs().max().item() if k.numel() else 0.0
                         for c in (slice(0, 3), 3, 4))
    if not (rgb == 0.0 and depth == 0.0 and log_t == 0.0):
        raise AssertionError(f"forward kernel vs plain: color {rgb} depth {depth} log T {log_t}")
    if not torch.equal(k_walk, p_walk):
        raise AssertionError(f"forward kernel vs plain: walk residual differs at "
                             f"{int((k_walk != p_walk).sum())} pixels")
    return max(rgb, depth, log_t), pairs, (k, k_walk), plain_ms


def check_bwd(args, out, walk, cot, col_offset=0):
    """The backward kernel vs its plain version on one input: every dinst
    column within TOL_GRAD after scaling by the column's largest
    magnitude, every value finite.  Returns (max abs error, scaled error,
    walked pairs, contributing pairs)."""
    import torch
    from freesplat_tpu_torch.ops import rasterizer as R

    with torch.no_grad():
        dk = R.composite_tiles_bwd(*args, out, walk, cot, col_offset=col_offset)
        dp, walked, contributed = R.composite_tiles_plain_bwd(*args, out, walk, cot,
                                                              count_pairs=True,
                                                              col_offset=col_offset)
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


# The C signatures of the baseline's rasterizer kernels: a tree from
# before the tile-column offset (PRs 1-9), whose entry points take
# (inst, tile_start, tile_count, num_tiles, tiles_x, ...) with no
# col_offset.  A baseline with another signature needs its own binding.
_P, _I = ctypes.c_void_p, ctypes.c_int
BASELINE_ARGTYPES = {
    "rasterize_fwd": [_P, _P, _P, _I, _I, _P, _P, _P],
    "rasterize_bwd": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
}


@contextlib.contextmanager
def baseline_kernels():
    """Inside, the rasterizer wrappers launch the kernels built from
    ``BASELINE`` (bound with ``BASELINE_ARGTYPES``) in place of this
    tree's; the wrappers' col_offset (the sixth argument) must be 0 and is
    not passed."""
    from freesplat_tpu_torch.ops import rasterizer as R

    own = R._kernel_entry

    def entry(name):
        fn = _baseline_fn(name)
        fn.restype, fn.argtypes = ctypes.c_int, BASELINE_ARGTYPES[name]

        def call(*args):
            if args[5] != 0:
                raise ValueError(f"baseline {name} has no col_offset, got {args[5]}")
            return fn(*args[:5], *args[6:])

        return call

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


def time_kernels(inst, binning, tiles_x, cmp, label, col_offset=0):
    """Both kernels' device time (``device_bench``: back-to-back launches),
    the plain versions' (CUDA events around one call), each kernel's bound
    and the warp-steps of each kernel with and without the cull, for one
    input, from ``compare_tiles``' results ``cmp``.  With ``BASELINE`` set,
    also ``baseline_times`` (whole views only).  ``col_offset``: the
    tiles' first image column (a slab)."""
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.utils.timing import device_bench

    _, _, pairs, (walked, contributed), (out, walk), cot, _ = cmp
    args = (inst, binning.tile_start, binning.tile_count, tiles_x)
    off = {"col_offset": col_offset}
    saved = dict(R.launch_count)
    fwd = (device_bench(functools.partial(R.composite_tiles_fwd, **off), [args], n=20) * 1e3,
           cuda_ms(lambda: R.composite_tiles_plain(*args, **off), reps=1))
    bwd = (device_bench(functools.partial(R.composite_tiles_bwd, **off),
                        [(*args, out, walk, cot)], n=20) * 1e3,
           cuda_ms(lambda: R.composite_tiles_plain_bwd(*args, out, walk, cot, **off), reps=1))
    if BASELINE is not None and col_offset == 0:
        baseline_times(args, out, walk, cot, label)
    R.launch_count.update(saved)  # timing launches are not the main path's
    steps = R.warp_steps_plain(*args, walk, **off)
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

    ctx = {k: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(DEVICE)
           for k, a in scene["context"].items() if k in VIEW_KEYS}
    tgt = {k: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(DEVICE)
           for k, a in scene["target"].items() if k in VIEW_KEYS}
    with torch.no_grad():
        g = encoder(ctx)["gaussians"]
    inst, binning = gaussian_view_inputs(g, tgt, capacity_factor, view)
    return inst, binning, ctx, tgt


def gaussian_view_inputs(g, tgt, capacity_factor, view=0):
    """The compositor's inputs for target view ``view`` of the Gaussians
    ``g`` (batch 1), as the decoder builds them; the Gaussians must be
    finite, one a context pixel."""
    import torch
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.ops.rendering import preprocess_gaussians

    with torch.no_grad():
        for f in ("means", "covariances", "harmonics", "opacities"):
            x = getattr(g, f)
            if x.shape[1] % (H * W) or not torch.isfinite(x).all():
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
    return inst, binning


def _count_dicts():
    from freesplat_tpu_torch.ops import gather as G
    from freesplat_tpu_torch.ops import plane_sweep as PS
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.scripts import probe_r3

    return R.launch_count, probe_r3.launch_count, G.launch_count, PS.launch_count


def launch_counts() -> dict:
    """Every kernel's launches since the last reset."""
    return {k: v for d in _count_dicts() for k, v in d.items()}


def reset_launch_counts():
    for d in _count_dicts():
        for k in d:
            d[k] = 0


def check_test_outputs(out: Path, summary: dict, launches: dict, views: int, sweeps: int,
                       label: str):
    """What ``run_test`` must leave after a run: finite summary values
    with SSIM <= 1, the FVS split and the depth metrics, the stats files
    and each scene's frame folders, and the forward kernel launched once
    per target view, the plane sweep once per trunk call (``sweeps``: a
    scene, or a chunk of one), no other kernel."""
    if DEVICE == "cuda" and launches != {"rasterize_fwd": views, "rasterize_bwd": 0,
                                         "gather_rows": 0, "segment_sum": 0,
                                         "plane_sweep": sweeps}:
        raise AssertionError(f"{label} launches {launches} for {views} target views and "
                             f"{sweeps} trunk calls")
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
        check_test_outputs(out, summary, launches, views, len(scenes), "serving")
        if SERVE_DUMPS is not None:
            import shutil

            shutil.copytree(out, SERVE_DUMPS, dirs_exist_ok=True)
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
    from freesplat_tpu_torch.training.trainer import (
        TrainCfg, deterministic_cudnn, fit, init_state, make_train_step,
    )

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
    sums = TRAIN_STEPS * segment_sums_per_step(cfg, 2, TRAIN_TARGET_VIEWS)
    if DEVICE == "cuda" and launches != {"rasterize_fwd": want, "rasterize_bwd": want,
                                         "gather_rows": 0, "segment_sum": sums,
                                         "plane_sweep": 0}:
        raise AssertionError(f"training launches {launches}, want {want} of each rasterizer "
                             f"kernel and {sums} segment sums")
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
        with deterministic_cudnn():  # as fit runs it
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

    def recording_bwd(*args, **kw):
        if not recorded:
            recorded.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return own_bwd(*args, **kw)

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
    # The multi-view depth term gathers once a step.
    sums = DEPTH_STEPS * (segment_sums_per_step(cfg, 2, TRAIN_TARGET_VIEWS) + 1)
    if DEVICE == "cuda" and launches != {"rasterize_fwd": want, "rasterize_bwd": want,
                                         "gather_rows": 0, "segment_sum": sums,
                                         "plane_sweep": 0}:
        raise AssertionError(f"depth-supervised launches {launches}, want {want} of each "
                             f"rasterizer kernel and {sums} segment sums")
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
        check_test_outputs(out, summary, launches, 4, 1, "replica")
        (entry,) = stats["per_scene"]
        if (entry["scene"], entry["num_views"]) != ("room0_1", 4):
            raise AssertionError(f"replica scene {entry['scene']} with {entry['num_views']} views")
    log(f"[replica] room0_1 (read from room0/) through main: 4 target views (1 extrapolation), "
        f"wall {wall:.2f} s, interpolation psnr {summary['interpolation_psnr']:.3f} ssim "
        f"{summary['interpolation_ssim']:.4f}, extrapolation psnr "
        f"{summary['extrapolation_psnr']:.3f}, depth_abs_rel {summary['depth_abs_rel']:.4f}, "
        f"launches {launches}")
    return launches


def native_phase() -> str:
    """The native frame decoder (``freesplat_tpu_torch/native``): built
    from its source into ``build/native/`` at first use, or the reason it
    is not.  When it built, a ScanNet-sized 1296x968 JPEG decoded to the
    loader's 640x480 against PIL's LANCZOS (the JAX bounds: max 6/255,
    mean 0.5/255) and the time a frame of the decoder (a batch of 8 on its
    thread pool), PIL's default resize and PIL's LANCZOS.  Returns the
    decoder the ScanNet-layout paths read frames with."""
    import shutil

    from PIL import Image

    from freesplat_tpu_torch import native

    tools = {"g++": shutil.which("g++") is not None}
    for header in ("jpeglib.h", "png.h"):
        tools[header] = any((Path(d) / header).exists() for d in (
            "/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu"))
    t0 = time.perf_counter()
    name = native.decoder_name()
    build_s = time.perf_counter() - t0
    if name != "native":
        log(f"[native] decoder pil: {native.build_error()}; toolchain {tools}")
        return name
    rng = np.random.default_rng(9)
    coarse = rng.uniform(0.15, 0.85, size=(61, 81, 3))
    frame = np.repeat(np.repeat(coarse, 16, axis=0), 16, axis=1)[:968, :1296]
    frame = (255 * np.clip(frame + 0.03 * rng.standard_normal(frame.shape), 0, 1)).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / f"{i}.jpg") for i in range(8)]
        for p in paths:
            Image.fromarray(frame).save(p, quality=95)
        got = native.load_jpeg_batch(paths[:1], 480, 640)[0]
        ref = np.asarray(Image.open(paths[0]).resize((640, 480), Image.LANCZOS),
                         np.float32) / 255.0
        err = np.abs(got - ref)
        if not (err.max() < 6.0 / 255.0 and err.mean() < 0.5 / 255.0):
            raise AssertionError(f"native decoder vs PIL LANCZOS: max {255 * err.max():.3f}/255, "
                                 f"mean {255 * err.mean():.3f}/255")
        times = {}
        for label, fn in (("native", lambda: native.load_jpeg_batch(paths, 480, 640)),
                          ("pil_default", lambda: [np.asarray(Image.open(p).resize((640, 480)))
                                                   for p in paths]),
                          ("pil_lanczos", lambda: [np.asarray(Image.open(p).resize(
                              (640, 480), Image.LANCZOS)) for p in paths])):
            fn()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            times[label] = 1e3 * (time.perf_counter() - t0) / (3 * len(paths))
    log(f"[native] decoder native ({native.library_path().relative_to(ROOT)}, first use "
        f"{build_s:.2f} s); toolchain {tools}; a 1296x968 JPEG to 640x480 against PIL LANCZOS: "
        f"max {255 * err.max():.4f}/255, mean {255 * err.mean():.4f}/255; ms a frame (host, "
        f"batches of 8): native {times['native']:.3f}, PIL default resize "
        f"{times['pil_default']:.3f}, PIL LANCZOS {times['pil_lanczos']:.3f}")
    return name


RE10K_H, RE10K_W = 360, 640  # RealEstate10K's frames
RE10K_SIDE = 256  # the re10k/2views preset's image side (passed explicitly)
RE10K_TRAIN_SCENES, RE10K_TRAIN_FRAMES = 3, 64
RE10K_STEPS = 4  # CLI train steps before the resume
RE10K_VIDEO_FRAMES = 60  # two paths of 30 frames
RE10K_INDEX = ROOT / "assets" / "evaluation_index_re10k_2views.json"


def write_re10k_chunk(path: Path, scenes) -> None:
    """A RealEstate10K ``.torch`` chunk of ``scenes`` ((key, frames, seed)
    each): 360x640 JPEG frames of a fresh 4,000-Gaussian cloud each,
    rendered by the tile rasterizer on the device along a slow forward
    chain (2 cm and 0.2 degrees a frame), with packed cameras (normalized
    fx, fy, cx, cy, two zeros, w2c 3x4) at a 60-degree horizontal field of
    view."""
    import torch
    from PIL import Image

    from freesplat_tpu_torch.data.synthetic import _random_scene
    from freesplat_tpu_torch.ops.rasterizer import rasterize

    fx = 0.5 / math.tan(math.radians(30.0))
    intr = np.array([[fx, 0, 0.5], [0, fx * RE10K_W / RE10K_H, 0.5], [0, 0, 1]], np.float32)
    intr_t = torch.from_numpy(intr).to(DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    chunk = []
    for key, frames, seed in scenes:
        scene = _random_scene(np.random.default_rng(seed), 4000, torch.device(DEVICE))
        cameras, images = [], []
        for i in range(frames):
            a = math.radians(0.2) * i
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
            c2w[:3, 3] = [0.02 * i, 0.0, 0.01 * i]
            with torch.no_grad():
                color, _, _ = rasterize(*scene, torch.from_numpy(c2w).to(DEVICE), intr_t,
                                        (RE10K_H, RE10K_W), bg, 0, capacity=1 << 20)
            buf = io.BytesIO()
            Image.fromarray((255 * color.clamp(0, 1)).to(torch.uint8).cpu().numpy()).save(
                buf, format="JPEG", quality=90)
            images.append(torch.frombuffer(bytearray(buf.getvalue()), dtype=torch.uint8))
            w2c = np.linalg.inv(c2w)
            cameras.append(np.concatenate([[fx, intr[1, 1], 0.5, 0.5, 0.0, 0.0],
                                           w2c[:3].reshape(-1)]).astype(np.float32))
        chunk.append({"key": key, "cameras": torch.from_numpy(np.stack(cameras)),
                      "images": images})
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(chunk, path)


def re10k_chunks(root: Path) -> str:
    """``root/train/000000.torch`` (RE10K_TRAIN_SCENES scenes of
    RE10K_TRAIN_FRAMES frames) and ``root/test/000000.torch`` (the first
    scene of the 2-view evaluation index with the frames it names, 134).
    Returns the test scene's key."""
    key, entry = next((k, v) for k, v in json.loads(RE10K_INDEX.read_text()).items() if v)
    t0 = time.perf_counter()
    write_re10k_chunk(root / "train" / "000000.torch",
                      [(f"train_{i}", RE10K_TRAIN_FRAMES, 40 + i) for i in range(RE10K_TRAIN_SCENES)])
    write_re10k_chunk(root / "test" / "000000.torch",
                      [(key, max(entry["context"] + entry["target"]) + 1, 50)])
    log(f"[re10k] chunks written in {time.perf_counter() - t0:.2f} s: train "
        f"{RE10K_TRAIN_SCENES} x {RE10K_TRAIN_FRAMES} frames, test {key} (frames "
        f"{entry['context']} context, {entry['target']} target)")
    return key


@contextlib.contextmanager
def recorded_renders(fwd_calls=(0,), bwd_calls=(0,), seg_calls=()):
    """Inside, the compositor inputs of the listed forward and backward
    launches and the ``segment_sum`` inputs of the listed segment sums
    (each counted from 0 inside the block) are kept, and the dropped
    count of every ``render_views`` call of validation, the videos and
    the harness.  Yields {"fwd": {i: args}, "bwd": {i: args}, "seg": {i:
    args}, "dropped": [tensors]}."""
    import torch
    from freesplat_tpu_torch.evaluation import harness as HA
    from freesplat_tpu_torch.evaluation import video as VI
    from freesplat_tpu_torch.ops import gather as G
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.training import validation as V

    rec = {"fwd": {}, "bwd": {}, "seg": {}, "dropped": []}
    n = {"fwd": 0, "bwd": 0, "seg": 0}
    own = {"fwd": R.composite_tiles_fwd, "bwd": R.composite_tiles_bwd, "seg": G.segment_sum}
    keep = {"fwd": set(fwd_calls), "bwd": set(bwd_calls), "seg": set(seg_calls)}

    def recording(kind):
        def fn(*args, **kw):
            if n[kind] in keep[kind]:
                rec[kind][n[kind]] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            n[kind] += 1
            return own[kind](*args, **kw)
        return fn

    renders = {m: m.render_views for m in (HA, VI, V)}

    def counting(fn):
        def render(*a, **kw):
            out = fn(*a, **kw)
            rec["dropped"].append(out.dropped.sum())
            return out
        return render

    R.composite_tiles_fwd, R.composite_tiles_bwd = recording("fwd"), recording("bwd")
    G.segment_sum = recording("seg")
    for m, fn in renders.items():
        m.render_views = counting(fn)
    try:
        yield rec
    finally:
        R.composite_tiles_fwd, R.composite_tiles_bwd = own["fwd"], own["bwd"]
        G.segment_sum = own["seg"]
        for m, fn in renders.items():
            m.render_views = fn


def re10k_view_checks(args, label, bwd_args=None):
    """The kernels against their plain versions on RE10K launches: the
    forward bit-equal on one forward launch's compositor inputs ``args``
    (inst, tile_start, tile_count, tiles_x); with ``bwd_args`` (one
    backward launch's inputs, its own cotangent last) the backward within
    TOL_GRAD scaled.  Prints the instances, the deepest one and the
    busiest tile.  Returns (forward error, backward error)."""
    saved = launch_counts()
    err, _, _, _ = compare_forward(args)
    bwd = ""
    bwd_err = 0.0
    if bwd_args is not None:
        bwd_err, scaled, _, _ = check_bwd(bwd_args[:4], *bwd_args[4:])
        bwd = (f", backward max_err {bwd_err:.3g} (scaled {scaled:.3g}) on a launch's own "
               f"cotangent")
    _restore_launch_counts(saved)  # comparison launches, not the main path's
    inst, tile_start, tile_count, _ = args
    log(f"[{label}] kernels vs plain: forward max_err {err:.3g} (bit-equal){bwd}; "
        f"{inst.shape[0]} instances, deepest z {float(inst[:, 9].max()):.2f}, "
        f"{tile_start.shape[0]} tiles, busiest tile {int(tile_count.max())}")
    return err, bwd_err


def check_segment_sums(captured, label) -> float:
    """The ``segment_sum`` kernel against its plain version, bit for bit,
    on each captured launch's inputs (src, order, offsets, rows).  Logs the
    shapes and returns the max abs error (0 when every launch is equal)."""
    import torch

    from freesplat_tpu_torch.ops import gather as G

    saved = launch_counts()
    err, longest = 0.0, 0
    for src, order, offsets, rows in captured:
        k = G.segment_sum(src, order, offsets, rows)
        p = G.segment_sum_plain(src, order, offsets, rows)
        sync()
        if k.numel():
            err = max(err, float((k - p).abs().max()))
        if not torch.equal(k, p):
            raise AssertionError(f"[{label}] segment_sum kernel vs plain at ({rows}, "
                                 f"{tuple(src.shape)}): max abs error {err}")
        longest = max(longest, int((offsets[1:] - offsets[:-1]).max()))
    _restore_launch_counts(saved)  # comparison launches, not the main path's
    shapes = sorted({(r, s.shape[0], s.shape[1]) for s, _, _, r in captured})
    log(f"[{label}] segment_sum: the {len(captured)} launches of one train step (rows, "
        f"entries, columns: {shapes}; longest segment {longest}) equal the plain version bit "
        f"for bit")
    return err


def _restore_launch_counts(saved: dict) -> None:
    for d in _count_dicts():
        for k in d:
            d[k] = saved[k]


def re10k_train_run(root: Path):
    """``main +experiment=re10k/2views mode=train`` at full width (256x256,
    D = 128, LPIPS weights from LPIPS_SEED) on the chunks under ``root``:
    RE10K_STEPS steps with a checkpoint at step 2 and a validation at step
    3 that writes both videos, then one resumed step (step 3, validated
    again).  Checks the launches
    by path, the metrics, ``dropped`` on every render and the videos;
    prints the warm step's split, the peak memory, and the kernels against
    their plain versions on the first train launch (its own cotangent for
    the backward), with their device times and bounds at that view, and
    the segment sums of the first train step against theirs."""
    from types import SimpleNamespace

    import torch
    from PIL import Image

    from freesplat_tpu_torch import main as M
    from freesplat_tpu_torch.config.config import load_config

    # As in serving and training at 384x512, seeded random weights make
    # splats larger than trained ones: at the preset's 3.0 instances a
    # Gaussian the train steps dropped 19,544 to 99,836 instances on the
    # H100 (PERF.md section 6), so the budget is raised.
    args = ["+experiment=re10k/2views", f"dataset.roots=[{root}]",
            f"dataset.image_shape=[{RE10K_SIDE},{RE10K_SIDE}]", "decoder.capacity_factor=8.0",
            f"trainer.max_steps={RE10K_STEPS}", "checkpointing.every_n_train_steps=2",
            "trainer.val_check_interval=3", "trainer.val_save_video=true", "trainer.log_every=1",
            f"loss.lpips.weights_path={lpips_npz()}"]
    cfg = load_config(args)
    side = cfg.dataset.image_shape[0]
    targets = 4  # the bounded sampler draws 4 targets for 2 context views
    sums = segment_sums_per_step(cfg, 2, targets, side, side)
    timings: dict = {}
    own_fit = M.fit
    M.fit = functools.partial(own_fit, timings=timings)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)  # the logger and validation write under outputs/local
        try:
            with counted_main("re10k") as run, \
                    recorded_renders(seg_calls=range(sums)) as rec:
                if DEVICE == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                first = run(args + [f"checkpointing.output_dir={tmp / 'ckpt'}"])
                peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
                warm = {k: list(v) for k, v in timings.items()}
                second = run(args + [f"checkpointing.load={tmp / 'ckpt'}",
                                     f"checkpointing.output_dir={tmp / 'ckpt2'}"])
                restored = run.restored
        finally:
            os.chdir(cwd)
            M.fit = own_fit
        local = tmp / "outputs" / "local"
        metrics = [json.loads(line) for line in (local / "metrics.jsonl").read_text().splitlines()]
        gifs = {}
        for name in ("wobble", "interpolation"):
            with Image.open(local / f"val_0000003_{name}.gif") as im:
                gifs[name] = (im.n_frames, im.size)
    runs = [(RE10K_STEPS, *first), (1, *second)]
    for steps, n_draws, n_vals, paths, _, _ in runs:
        want = {
            "re10k_data": {"rasterize_fwd": 0, "rasterize_bwd": 0, "segment_sum": 0},
            "re10k_train": {"rasterize_fwd": targets * steps, "rasterize_bwd": targets * steps,
                            "segment_sum": sums * steps},
            "re10k_val": {"rasterize_fwd": (targets + RE10K_VIDEO_FRAMES) * n_vals,
                          "rasterize_bwd": 0, "segment_sum": 0},
        }
        got = {p: {k: v.get(k, 0) for k in ("rasterize_fwd", "rasterize_bwd", "segment_sum")}
               for p, v in paths.items()}
        if DEVICE == "cuda" and (got != want or paths["re10k_train"].get("gather_rows", 0)):
            raise AssertionError(f"re10k_train launches {paths}, want {want} ({n_draws} batches "
                                 f"drawn, {n_vals} validations)")
    if runs[0][2] != 1 or runs[1][2] != 1:  # each run validates at step 3
        raise AssertionError(f"re10k_train validations {runs[0][2]}, {runs[1][2]}: want 1, 1")
    if not restored or restored[0][:2] != (2, 3):
        raise AssertionError(f"re10k resume restored {restored}, want step_2 holding step 3")
    if [m["step"] for m in metrics] != [*range(RE10K_STEPS), RE10K_STEPS - 1]:
        raise AssertionError(f"re10k_train logged steps {[m['step'] for m in metrics]}")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()) or m["dropped_instances"] != 0:
            raise AssertionError(f"re10k_train step {m['step']}: {m}")
    dropped = int(sum(int(d) for d in rec["dropped"]))
    if dropped or gifs != {k: (30, (side, side)) for k in gifs}:
        raise AssertionError(f"re10k validation: dropped {dropped}, videos {gifs}")
    split = {k: float(np.median([1e3 * t for t in warm[k][1:]]))
             for k in ("forward_s", "backward_s", "optimizer_s")}
    step_ms = [1e3 * sum(x) for x in zip(warm["forward_s"], warm["backward_s"],
                                         warm["optimizer_s"])]
    log(f"[re10k_train] main +experiment=re10k/2views mode=train at {side}x{side}, D = "
        f"{cfg.encoder.num_depth_candidates}, 2 context + {targets} target views: "
        f"{RE10K_STEPS} steps then 1 resumed, walls {runs[0][5]:.2f} s and {runs[1][5]:.2f} s; "
        f"ms per step {[round(t, 2) for t in step_ms]}, warm median "
        f"{float(np.median(step_ms[1:])):.2f} (forward {split['forward_s']:.2f}, backward "
        f"{split['backward_s']:.2f}, optimizer {split['optimizer_s']:.2f}); peak memory {peak} B; "
        f"loss {[round(m['loss'], 5) for m in metrics]}; validation videos {gifs}; "
        f"launches {runs[0][3]} then {runs[1][3]}")
    inst, tile_start, tile_count, tiles_x = rec["fwd"][0]
    errs = re10k_view_checks(rec["fwd"][0], "re10k_train", rec["bwd"][0])
    if DEVICE == "cuda" and len(rec["seg"]) != sums:
        raise AssertionError(f"re10k_train: {len(rec['seg'])} segment sums captured, want {sums}")
    seg_err = check_segment_sums([rec["seg"][i] for i in sorted(rec["seg"])], "re10k_train")
    binning = SimpleNamespace(tile_start=tile_start, tile_count=tile_count, dropped=0)
    cmp = compare_tiles(inst, binning, tiles_x, seed=4)
    timing = time_kernels(inst, binning, tiles_x, cmp, "re10k train view")
    return _sum_paths(runs), errs, seg_err, timing


def re10k_test_run(root: Path, key: str):
    """``main +experiment=re10k/2views mode=test`` with the 2-view index,
    ``test.save_ply=true test.save_video=true`` and LPIPS weights from
    LPIPS_SEED, on the test chunk under ``root``.  Checks the metrics,
    ``dropped`` on every render, the PLY's vertex count against the valid
    Gaussians, both GIFs and the launches; prints the time split; holds
    the forward kernel against plain at the first target view and the
    first wobble frame."""
    from PIL import Image

    from freesplat_tpu_torch import main as M
    from freesplat_tpu_torch.evaluation import harness as HA
    from freesplat_tpu_torch.evaluation import video as VI
    from freesplat_tpu_torch.utils.ply_export import load_ply

    entry = json.loads(RE10K_INDEX.read_text())[key]
    targets = len(entry["target"])
    timings: dict = {}
    own_run_test, own_save_video = HA.run_test, VI.save_video
    HA.run_test = functools.partial(own_run_test, timings=timings)

    def timed_save_video(*a, **kw):  # the GIF writing inside video_s
        t0 = time.perf_counter()
        own_save_video(*a, **kw)
        timings.setdefault("gif_s", []).append(time.perf_counter() - t0)

    VI.save_video = timed_save_video
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                recorded_renders(fwd_calls=(0, targets), bwd_calls=()) as rec:
            out = Path(tmp)
            reset_launch_counts()
            t0 = time.perf_counter()
            M.main(["+experiment=re10k/2views", "mode=test", f"dataset.roots=[{root}]",
                    f"dataset.image_shape=[{RE10K_SIDE},{RE10K_SIDE}]",
                    "test.render_capacity_factor=8.0",  # seeded weights (re10k_train_run)
                    f"dataset.evaluation_index_path={RE10K_INDEX}", f"test.output_path={out}",
                    "test.save_ply=true", "test.save_video=true",
                    f"loss.lpips.weights_path={lpips_npz()}"], device=DEVICE)
            sync()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            stats = json.loads((out / "stats.json").read_text())
            (scene,) = stats["per_scene"]
            ply = load_ply(out / key / "gaussians.ply")
            gifs = {}
            for name in ("wobble", "interpolation"):
                with Image.open(out / key / f"{name}.gif") as im:
                    gifs[name] = (im.n_frames, im.size)
            ply_bytes = (out / key / "gaussians.ply").stat().st_size
    finally:
        HA.run_test, VI.save_video = own_run_test, own_save_video
    summary = stats["summary"]
    side = RE10K_SIDE
    want = {"rasterize_fwd": targets + RE10K_VIDEO_FRAMES, "rasterize_bwd": 0,
            "gather_rows": 0, "segment_sum": 0, "plane_sweep": 1}
    if DEVICE == "cuda" and launches != want:
        raise AssertionError(f"re10k_test launches {launches}, want {want}")
    if not all(math.isfinite(summary.get(k, math.nan)) for k in ("psnr", "ssim", "lpips")):
        raise AssertionError(f"re10k_test metrics: {summary}")
    dropped = int(sum(int(d) for d in rec["dropped"]))
    if dropped or scene["dropped_instances"] != 0:
        raise AssertionError(f"re10k_test dropped {dropped} (video and targets), "
                             f"{scene['dropped_instances']} (targets)")
    if (scene["scene"], scene["num_views"]) != (key, targets):
        raise AssertionError(f"re10k_test scene {scene['scene']} with {scene['num_views']} views")
    if len(ply["x"]) != scene["num_gaussians"] or not all(
            np.isfinite(v).all() for v in ply.values()):
        raise AssertionError(f"gaussians.ply holds {len(ply['x'])} vertices for "
                             f"{scene['num_gaussians']} valid Gaussians")
    if gifs != {k: (30, (side, side)) for k in gifs}:
        raise AssertionError(f"re10k_test videos {gifs}")
    split = {k: round(1e3 * timings[k][0], 2)
             for k in ("encoder_s", "metrics_s", "dumps_s", "ply_s", "video_s")}
    split["render_s"] = round(1e3 * timings["decoder_s_per_view"][0] * targets, 2)
    log(f"[re10k_test] {key} through main +experiment=re10k/2views mode=test at {side}x{side}: "
        f"{targets} target views, wall {wall:.2f} s; ms: encode {split['encoder_s']}, render "
        f"{split['render_s']}, metrics {split['metrics_s']}, dumps {split['dumps_s']}, ply "
        f"{split['ply_s']}, video {split['video_s']} ({RE10K_VIDEO_FRAMES} frames; writing the "
        f"two GIFs {round(1e3 * sum(timings['gif_s']), 2)}); psnr "
        f"{summary['psnr']:.3f}, ssim {summary['ssim']:.4f}, lpips {summary['lpips']:.4f}; "
        f"num_gaussians {scene['num_gaussians']:.0f} = PLY vertices ({ply_bytes} B); "
        f"videos {gifs}; launches {launches}")
    errs = [re10k_view_checks(rec["fwd"][0], "re10k_test target view 0")[0],
            re10k_view_checks(rec["fwd"][targets], "re10k_test wobble frame 0")[0]]
    return launches, max(errs)


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


def sweep_case(seed: int, b: int, s: int, behind: dict, h=96, w=128, c=48, d=128):
    """A ``CostVolume`` whose head is drawn from ``seed`` and its inputs on
    DEVICE: ``b`` views at matching resolution h x w, each swept against
    ``s`` sources over D = ``d`` planes from 0.5 to 15 m.  Source j of a
    view sits 0.1 to 0.6 m along +x, -x, +y, -y in turn, turned up to
    0.15 rad, so near planes project off the map on every side; the first
    ``behind[i]`` sources of view i are turned round, every point then
    behind them (z <= 0)."""
    import torch
    from freesplat_tpu_torch.models.cost_volume import CostVolume

    rng = np.random.default_rng(seed)
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.75 * w
    k[0, 2], k[1, 2] = w / 2, h / 2
    src_T_cur = np.tile(np.eye(4), (b, s, 1, 1))
    for i in range(b):
        for j in range(s):
            yaw, pitch = rng.uniform(-0.15, 0.15), rng.uniform(-0.05, 0.05)
            if j < behind.get(i, 0):
                yaw += math.pi
            ry = np.array([[math.cos(yaw), 0, math.sin(yaw)], [0, 1, 0],
                           [-math.sin(yaw), 0, math.cos(yaw)]])
            rx = np.array([[1, 0, 0], [0, math.cos(pitch), -math.sin(pitch)],
                           [0, math.sin(pitch), math.cos(pitch)]])
            rot = rx @ ry
            centre = np.zeros(3)
            centre[j % 4 // 2] = (1 - 2 * (j % 2)) * rng.uniform(0.1, 0.6)
            centre += 0.02 * rng.standard_normal(3)
            src_T_cur[i, j, :3, :3] = rot
            src_T_cur[i, j, :3, 3] = -rot @ centre
    torch.manual_seed(seed)
    cv = CostVolume(c, num_depth_bins=d).to(DEVICE).eval()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(DEVICE)

    args = (dev(rng.standard_normal((b, h, w, c))), dev(rng.standard_normal((b, s, h, w, c))),
            dev(src_T_cur), dev(np.tile(k, (b, s, 1, 1))), dev(np.tile(np.linalg.inv(k), (b, 1, 1))),
            dev(np.full(b, 0.5)), dev(np.full(b, 15.0)))
    return cv, args


def sweep_edges(cv, args) -> dict:
    """How many (view, source, plane, pixel) samples of a case land left
    of, right of, above and below the map in front of their source, and
    behind it (z <= 0)."""
    import torch
    from freesplat_tpu_torch.models.cost_volume import inverse_depth_planes

    cur, _, src_T_cur, src_K, cur_invK, near, far = args
    b, h, w, _ = cur.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=cur.device) + 0.5,
                            torch.arange(w, device=cur.device) + 0.5, indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    rays = torch.einsum("bij,nj->bni", cur_invK[:, :3, :3], pix)
    depths = inverse_depth_planes(cv.num_depth_bins, near, far)
    out = {k: 0 for k in ("left", "right", "above", "below", "behind")}
    for i in range(b):  # one view at a time: (s, D, n, 3) per view
        cam = rays[i][None] * depths[i][:, None, None]
        p = torch.einsum("sij,dnj->sdni", (src_K[i] @ src_T_cur[i])[:, :3, :3], cam) \
            + (src_K[i] @ src_T_cur[i])[:, None, None, :3, 3]
        z = p[..., 2]
        uv = p[..., :2] / z[..., None]
        front = z > 0
        out["behind"] += int((~front).sum())
        out["left"] += int((front & (uv[..., 0] < 0)).sum())
        out["right"] += int((front & (uv[..., 0] >= w)).sum())
        out["above"] += int((front & (uv[..., 1] < 0)).sum())
        out["below"] += int((front & (uv[..., 1] >= h)).sum())
    return out


def sweep_bound(args, d: int) -> tuple[float, str, int, int]:
    """(bound ms, bound by, operations, bytes) of one fused call."""
    cur, src = args[:2]
    b, h, w, c = cur.shape
    s, n = src.shape[1], h * w
    rows = b * d * n
    ops = (rows * s * (SWEEP_OPS_PER_SAMPLE + SWEEP_OPS_PER_SAMPLE_CHANNEL * c)
           + rows * ((c + 1) + 2 * (c + 1) * 32 + 2 * 32 * 32 + 2 * 32 + 5 * 32 + 1))
    head = (c + 1) * 32 + 32 * 32 + 3 * 32 + 1
    moved = 4 * (cur.numel() + src.numel() + b * d + b * n * 3 + b * s * 12 + head + rows)
    return (*_bound(moved, ops), ops, moved)


def plane_sweep_phase():
    """The fused plane sweep (``csrc/plane_sweep.cu``) against the
    plane-chunk loop of ``CostVolume`` on the card, at the whole-scene
    chunk (15 views x 4 sources) and the 2-view shape (2 views x 1
    source), both 96 x 128, c = 48, D = 128 over 0.5-15 m, heads drawn
    from a seed: within SWEEP_TOL, two calls bit-equal, one launch a call;
    samples off the map on each side and behind their source counted (the
    cases together hit each);
    views whose every source is behind read the head of a zero input (the
    1e-8 denominator).  Device ms of the fused call and of the loop, with
    the bound (CUDA events around back-to-back calls).  Returns (max
    relative error, (ms, plain ms, bound ms, bound by), the 2-view
    shape's (ms, plain ms, bound ms, bound by))."""
    import torch
    from freesplat_tpu_torch.ops import plane_sweep as PS

    worst, times, seen = 0.0, [], collections.Counter()
    # (label, seed, views, sources, views -> leading sources turned round)
    cases = (("whole-scene chunk", 21, 15, 4, {1: 1, 2: 4}), ("2-view", 22, 2, 1, {1: 1}))
    for label, seed, b, s, behind in cases:
        cv, args = sweep_case(seed, b, s, behind)
        edges = sweep_edges(cv, args)
        seen.update(edges)
        with torch.no_grad():
            before = PS.launch_count["plane_sweep"]
            fused, again = cv(*args), cv(*args)
            sync()
            if PS.launch_count["plane_sweep"] != before + 2:
                raise AssertionError(f"[plane_sweep] {label}: the kernel launched "
                                     f"{PS.launch_count['plane_sweep'] - before} times in 2 calls")
            cv.kernel_takes = lambda *a: False  # the plane-chunk loop, on the card
            plain = cv(*args)
            sync()
            zero = cv.mlp(torch.zeros(1, args[0].shape[-1] + 1, device=DEVICE))[0, 0]
            loop_ms = cuda_ms(lambda: cv(*args), 2)
            del cv.kernel_takes
            kernel_ms = cuda_ms(lambda: cv(*args), 10)
        scale = plain.abs().max().item()
        err = (fused - plain).abs().max().item() / scale
        same = (fused == plain).float().mean().item()
        worst = max(worst, err)
        # Views whose every source is behind: every row's input is 0, so
        # every row reads one value, the head of 0.
        all_behind = [i for i, k in behind.items() if k == s]
        flat = max((fused[i] - zero).abs().max().item() / scale for i in all_behind)
        one_value = all(bool((fused[i] == fused[i].flatten()[0]).all()) for i in all_behind)
        if not (torch.isfinite(fused).all() and err <= SWEEP_TOL and torch.equal(fused, again)
                and flat <= SWEEP_TOL and one_value):
            raise AssertionError(
                f"[plane_sweep] {label}: max |fused - loop| / max |loop| {err:.3g} (limit "
                f"{SWEEP_TOL}), finite {bool(torch.isfinite(fused).all())}, two calls equal "
                f"{torch.equal(fused, again)}; views {all_behind} with every source behind: one "
                f"value {one_value}, off the head of 0 by {flat:.3g}")
        bound_ms, bound_by, ops, moved = sweep_bound(args, cv.num_depth_bins)
        taps = 4 * 4 * args[1].shape[-1] * b * s * cv.num_depth_bins * fused.shape[1] * fused.shape[2]
        log(f"[plane_sweep] {label} ({b} views x {s} sources, 96x128, c 48, D 128): max |fused - "
            f"loop| / max |loop| {err:.3g} (max |loop| {scale:.4g}; limit {SWEEP_TOL}), bit-equal "
            f"share {same:.6f}, two calls "
            f"bit-equal, samples off the map / behind {edges}, views {all_behind} with every "
            f"source behind read the head of 0 ({flat:.3g}); device ms a call: fused "
            f"{kernel_ms:.4f}, loop {loop_ms:.2f}; bound {bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.2f} "
            f"GFLOP, {moved / 1e6:.1f} MB), taps read {taps / 1e9:.2f} GB from L1/L2")
        times.append((kernel_ms, loop_ms, bound_ms, bound_by))
        del cv, args, fused, again, plain
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    if len(seen) < 5 or min(seen.values()) == 0:
        raise AssertionError(f"[plane_sweep] the cases miss an edge: {dict(seen)}")
    return worst, times[0], times[1]


def probe_run():
    """``scripts/probe_r3.main(["all"])`` in-process, as a user runs it.
    Returns its launches and results."""
    from freesplat_tpu_torch.scripts import probe_r3

    reset_launch_counts()
    results = probe_r3.main(["all"], device=DEVICE)
    launches = launch_counts()
    if DEVICE == "cuda" and not all(launches[k] for k in ("rasterize_fwd", "rasterize_bwd",
                                                          "gather_rows")):
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


@contextlib.contextmanager
def counted_main(prefix: str, test_path: bool = False):
    """Inside, ``main``'s batch streams, validations and checkpoint
    restores are wrapped, and ``run(argv)`` calls ``main`` once (or
    ``entry(argv, device=...)``, a script that calls ``main``).  Launches
    are split by path: ``<prefix>_data`` while a batch is drawn,
    ``<prefix>_val`` inside ``validation_step``, with ``test_path``
    ``<prefix>_test`` inside ``main.test`` (but its batch draws),
    ``<prefix>_train`` the rest of the run.  A restored state is held against the checkpoint it
    was read from (``run.restored`` lists the restores).  ``run`` returns
    (batches drawn, validations, launches by path, what ``main`` printed,
    wall seconds)."""
    import torch
    from freesplat_tpu_torch import main as M
    from freesplat_tpu_torch.training import checkpoint as C
    from freesplat_tpu_torch.training import validation as V

    data, train, val, test = (f"{prefix}_{p}" for p in ("data", "train", "val", "test"))
    by_path: dict[str, dict] = {data: {}, train: {}, val: {}}
    if test_path:
        by_path[test] = {}
    draws, vals, restored = [0], [0], []

    def add(path, before):
        now = launch_counts()
        for k in now:
            by_path[path][k] = by_path[path].get(k, 0) + now[k] - before[k]

    orig_batches, orig_val, orig_restore = M.make_batches, V.validation_step, M.restore_checkpoint
    orig_test = M.test

    def counted_batches(*a, **kw):
        it = orig_batches(*a, **kw)

        def gen():
            while True:
                before = launch_counts()
                batch = next(it, None)
                add(data, before)
                if batch is None:
                    return
                draws[0] += 1
                yield batch

        return gen()

    def counted_val(*a, **kw):
        before = launch_counts()
        out = orig_val(*a, **kw)
        add(val, before)
        vals[0] += 1
        return out

    def counted_test(*a, **kw):
        before, drawn = launch_counts(), dict(by_path[data])
        out = orig_test(*a, **kw)
        add(test, before)
        for k, v in by_path[data].items():  # the test's batch draws stay data
            by_path[test][k] -= v - drawn.get(k, 0)
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

    def run(argv, entry=None):
        reset_launch_counts()
        draws[0] = vals[0] = 0
        for p in by_path.values():
            p.clear()
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            (entry or M.main)(argv, device=DEVICE)
        sync()
        wall = time.perf_counter() - t0
        total = launch_counts()
        for k in total:
            by_path[train][k] = total[k] - sum(c.get(k, 0) for p, c in by_path.items()
                                               if p != train)
        return draws[0], vals[0], {p: dict(v) for p, v in by_path.items()}, \
            tee.buf.getvalue(), wall

    run.restored = restored
    M.make_batches, V.validation_step, M.restore_checkpoint = (
        counted_batches, counted_val, checked_restore)
    if test_path:
        M.test = counted_test
    try:
        yield run
    finally:
        M.make_batches, V.validation_step, M.restore_checkpoint = (
            orig_batches, orig_val, orig_restore)
        M.test = orig_test


def _sum_paths(runs) -> dict:
    """Launches by path summed over ``counted_main`` runs."""
    total: dict = {}
    for run in runs:
        for p, counts in run[3].items():
            for k, v in counts.items():
                total.setdefault(p, {}).setdefault(k, 0)
                total[p][k] += v
    return total


def cli_run():
    """``main`` trains CLI_STEPS steps on the synthetic stream (checkpoint
    at step 2, validation at step 3) in a temporary directory, then a
    second ``main`` resumes from the checkpoint.  Launches are split by
    path: data renders (each batch drawn), validation renders and the
    train steps (the rest)."""
    lpips_path = lpips_npz()
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
        try:
            with counted_main("cli") as run:
                runs = [(CLI_STEPS, *run(args + [f"checkpointing.output_dir={tmp / 'ckpt'}"])),
                        (1, *run(args + [f"checkpointing.load={tmp / 'ckpt'}",
                                         f"checkpointing.output_dir={tmp / 'ckpt2'}"]))]
                restored = run.restored
        finally:
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
    return _sum_paths(runs), step_ms


def segment_sums_per_step(cfg, context_views, target_views, h=None, w=None) -> int:
    """Segment-sum launches of one train step at ``h`` x ``w`` (default
    H x W): one for each target view's instance gather, four (the bilinear
    taps) for each plane chunk of the cost volume
    (``models/cost_volume.py``)."""
    from freesplat_tpu_torch.models.cost_volume import CostVolume

    sources = min(cfg.encoder.num_views, context_views) - 1
    n = ((h or H) // 4) * ((w or W) // 4)
    d = cfg.encoder.num_depth_candidates
    chunk = max(1, min(d, CostVolume.budget_rows // max(context_views * sources * n, 1)))
    return target_views + 4 * -(-d // chunk)


def whole_scene_batches(n_scenes, seed=0):
    """``whole_scene_bench``'s synthetic scenes (a fresh Gaussian cloud
    each, tile-rendered on the card), drawn before the run so that their
    renders are not counted as the run's launches."""
    from freesplat_tpu_torch.data.synthetic import SyntheticCfg, synthetic_batches

    it = synthetic_batches(SyntheticCfg(image_shape=(H, W), num_context=WS_VIEWS,
                                        num_target=WS_TARGETS, renderer="tile", vary_scene=True,
                                        seed=seed), device=DEVICE)
    scenes = [next(it) for _ in range(n_scenes)]
    sync()
    return scenes


def whole_scene_pass(scenes, overrides, label):
    """``run_test`` over ``scenes`` with ``whole_scene_bench``'s config and
    ``overrides``; checks the launches (one forward a target view) and
    the summary, prints each scene's phase split.  Returns (summary,
    timings, peak bytes, launches)."""
    import torch
    from freesplat_tpu_torch.evaluation.harness import run_test
    from freesplat_tpu_torch.scripts.whole_scene_bench import bench_config

    timings: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = bench_config(WS_VIEWS, H, W, tmp, WS_DEPTH, overrides=overrides)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        summary = run_test(cfg, batches=iter(scenes), device=DEVICE, timings=timings)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
        stats = json.loads((Path(tmp) / "stats.json").read_text())
    views = WS_TARGETS * len(scenes)
    # One plane sweep a trunk chunk in float32; bfloat16 takes the loop.
    sweeps = (len(scenes) * -(-WS_VIEWS // cfg.test.encode_view_chunk)
              if cfg.encoder.compute_dtype == "float32" else 0)
    if DEVICE == "cuda" and launches != {"rasterize_fwd": views, "rasterize_bwd": 0,
                                         "gather_rows": 0, "segment_sum": 0,
                                         "plane_sweep": sweeps}:
        raise AssertionError(f"{label} launches {launches} for {views} target views")
    if not all(math.isfinite(v) for v in summary.values()):
        raise AssertionError(f"{label}: non-finite summary {summary}")
    ms = {k: [round(1e3 * t, 2) for t in v] for k, v in timings.items()}
    chunks = len(ms["B_trunk_s"]) // len(scenes)
    for i, e in enumerate(stats["per_scene"]):
        log(f"[{label}] scene {i} ({e['scene']}, {WS_VIEWS} context views {H}x{W}): encode "
            f"{ms['encoder_s'][i]} ms = A match {ms['A_match_s'][i]}, geometry "
            f"{ms['A_geometry_s'][i]}, B trunk {ms['B_trunk_s'][i * chunks:(i + 1) * chunks]} "
            f"(chunks of {cfg.test.encode_view_chunk}), concat {ms['B_concat_s'][i]}, C1 PTF "
            f"{ms['C1_ptf_s'][i]}, "
            f"C2 head {ms['C2_head_s'][i]}; render {ms['decoder_s_per_view'][i]} ms a view; "
            f"metrics {ms['metrics_s'][i]} ms, dumps {ms['dumps_s'][i]} ms; num_gaussians "
            f"{e['num_gaussians']:.0f}, gs_ratio {e['gs_ratio']:.4f}, dropped "
            f"{e['dropped_instances']:.0f}, psnr {e['psnr']:.3f}")
    log(f"[{label}] {len(scenes)} scenes, wall {wall:.2f} s, peak memory {peak} B, launches "
        f"{launches}")
    return summary, timings, peak, launches


def state_digest(module) -> str:
    """The first 16 hex digits of the sha256 of ``module``'s state_dict
    (names and bytes, in order): one seed's weights compared across
    machines and torch versions."""
    import hashlib

    h = hashlib.sha256()
    for k, t in module.state_dict().items():
        h.update(k.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def encode_witness(ctx):
    """Card against host CPU on shared weights: ``whole_scene_bench``'s
    encoder from its seed, in float32 and in bfloat16, encodes the first
    WITNESS_VIEWS views of the scene ``ctx`` with the chunked encode on
    the card ("card"), and a copy of the same module moved to the host CPU
    encodes them there ("host").  The card also encodes the whole scene in
    float32, for its Gaussians.  Returns ({(where, dtype): depth_s-1 on
    the CPU}, {(where, dtype): seconds}, the card's float32 Gaussians of
    the whole scene, the weights' ``state_digest``)."""
    import copy

    import torch
    from freesplat_tpu_torch.evaluation.harness import make_chunked_encode
    from freesplat_tpu_torch.models.encoder import make_encoder
    from freesplat_tpu_torch.scripts.whole_scene_bench import bench_config

    depth, secs, gaussians, digest = {}, {}, None, None
    sub = {k: v[:, :WITNESS_VIEWS] for k, v in ctx.items()}
    host_sub = {k: v.cpu() for k, v in sub.items()}
    for dtype in ("float32", "bfloat16"):
        cfg = bench_config(WS_VIEWS, H, W, "unused", WS_DEPTH,
                           overrides=[f"encoder.compute_dtype={dtype}"])
        encoder = make_encoder(dataclasses.replace(cfg.encoder, train_bn=cfg.test.bn_batch_stats),
                               device=DEVICE, seed=cfg.seed)
        digest = digest or state_digest(encoder)
        for where, enc, c in (("card", encoder, sub),
                              ("host", copy.deepcopy(encoder).cpu(), host_sub)):
            t0 = time.perf_counter()
            with torch.no_grad():
                out = make_chunked_encode(enc, cfg.test.encode_view_chunk)(c)
            depth[where, dtype] = out["depth_s-1"].float().cpu()
            secs[where, dtype] = time.perf_counter() - t0
            del enc, out
        if dtype == "float32":
            with torch.no_grad():
                gaussians = make_chunked_encode(encoder, cfg.test.encode_view_chunk)(ctx)[
                    "gaussians"]
        del encoder
    return depth, secs, gaussians, digest


def witness_readings(depth) -> dict:
    """Relative L2 of ``depth_s-1`` between the witness's four encodes,
    over the scene and in its worst view."""
    import torch

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    pairs = {"card_vs_host_f32": (("card", "float32"), ("host", "float32")),
             "card_vs_host_bf16": (("card", "bfloat16"), ("host", "bfloat16")),
             "card_bf16_vs_f32": (("card", "bfloat16"), ("card", "float32")),
             "host_bf16_vs_f32": (("host", "bfloat16"), ("host", "float32"))}
    return {name: (rel(depth[a], depth[b]),
                   max(rel(x, y) for x, y in zip(depth[a][0], depth[b][0])))
            for name, (a, b) in pairs.items()}


def whole_scene_run():
    """The whole-scene path (``scripts/whole_scene_bench.py``'s config
    through ``run_test``): 2 synthetic scenes of WS_VIEWS context and
    WS_TARGETS target views at 384x512, D = 128, nearest-5 sources,
    15 views a trunk chunk, render capacity factor 1.0; float32,
    then ``encoder.compute_dtype=bfloat16`` on the same scenes.  Then the
    encoder on the card against the same weights on the host CPU
    (``encode_witness``) on the first WITNESS_VIEWS views of the first
    scene, float32 and bfloat16; and the
    forward kernel vs plain on one target view of that scene's fused
    Gaussians.  Returns the launches of both passes and the forward
    kernel's numbers at the whole-scene view."""
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.utils.timing import device_bench

    scenes = whole_scene_batches(2)
    _, f32_t, _, launches = whole_scene_pass(scenes, [], "whole_scene")
    _, bf16_t, _, bf16_launches = whole_scene_pass(
        scenes, ["encoder.compute_dtype=bfloat16"], "whole_scene_bf16")
    log(f"[whole_scene_bf16] warm encode (scene 1) {1e3 * bf16_t['encoder_s'][1]:.2f} ms in "
        f"bfloat16 against {1e3 * f32_t['encoder_s'][1]:.2f} ms in float32 (same run); trunk "
        f"chunks {[round(1e3 * t, 2) for t in bf16_t['B_trunk_s'][-2:]]} against "
        f"{[round(1e3 * t, 2) for t in f32_t['B_trunk_s'][-2:]]} ms")

    ctx = {k: scenes[0]["context"][k] for k in VIEW_KEYS}
    tgt = {k: scenes[0]["target"][k] for k in VIEW_KEYS}
    depth, secs, gaussians, digest = encode_witness(ctx)
    read = witness_readings(depth)
    d32 = depth["card", "float32"]
    log(f"[witness] the first {WITNESS_VIEWS} views of scene 0, weights {digest}: depth_s-1 "
        f"relative L2 (scene; worst view) "
        + ", ".join(f"{k} {v[0]:.4g}; {v[1]:.4g}" for k, v in read.items())
        + f"; card float32 depth {float(d32.min()):.4g} to {float(d32.max()):.4g}, std "
        f"{float(d32.std()):.4g}; encode s "
        + ", ".join(f"{w} {d} {t:.2f}" for (w, d), t in secs.items()))
    if not all(bool(x.isfinite().all()) for x in depth.values()):
        raise AssertionError("non-finite depth_s-1 in the card/host witness")
    for name, limit in WITNESS_LIMITS.items():
        if read[name][0] > limit:
            raise AssertionError(f"witness {name}: relative L2 {read[name][0]} > {limit}")

    inst, binning = gaussian_view_inputs(gaussians, tgt, 1.0, view=0)
    del gaussians
    saved = dict(R.launch_count)
    args = (inst, binning.tile_start, binning.tile_count, W // 16)
    err, pairs, _, plain_ms = compare_forward(args)
    ms = device_bench(R.composite_tiles_fwd, [args], n=10) * 1e3
    R.launch_count.update(saved)  # comparison launches, not the main path's
    k = inst.shape[0]
    num_tiles = binning.tile_start.shape[0]
    evaluated, blended, stopped = pairs
    bound = _bound(k * 40 + num_tiles * 8 + num_tiles * 256 * (5 + 1) * 4,
                   blended * FLOPS_PER_PAIR + stopped * FLOPS_PER_PAIR_STOP
                   + (evaluated - blended - stopped) * FLOPS_PER_PAIR_CUT)
    count = binning.tile_count.long()
    log(f"[whole_scene] target view 0 of scene 0: forward kernel vs plain max_err {err} (walk "
        f"equal); {k} instances of {int(binning.num_instances)} (dropped "
        f"{int(binning.dropped)}); tiles {num_tiles}, instances a tile max {int(count.max())} "
        f"mean {float(count.float().mean()):.1f}, {int((count >= R.MAX_TILE_INSTANCES).sum())} "
        f"at the {R.MAX_TILE_INSTANCES} cap; kernel {ms:.4f} ms (device time), plain "
        f"{plain_ms:.2f} ms, bound {bound[0]:.4f} ms ({bound[1]}; {evaluated} pairs evaluated, "
        f"{blended} blended, {stopped} terminating)")
    return {"whole_scene": launches, "whole_scene_bf16": bf16_launches}, err, \
        (ms, plain_ms, *bound)


def write_scannet_scene(root: Path, index_path: Path, seed=8) -> str:
    """A ScanNet-layout test scene at 640x480 for the first key of
    ``index_path``: JPEG color and uint16 millimetre depth with holes at
    frame 0 (the loader reads its size) and at the indices the key names,
    intrinsics, and c2w poses for every frame up to the last on a slow
    arc.  Returns the key."""
    from PIL import Image

    key, entry = next(iter(json.loads(index_path.read_text()).items()))
    frames = sorted({0, *entry["context"], *entry["target"], *entry.get("extrapolation", [])})
    n = frames[-1] + 1
    scene = root / "test" / key[:-2]  # the loader strips the "_0" suffix
    for sub in ("color", "depth", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    rng = np.random.default_rng(seed)
    depth_mm = (1000 * sensor_depth(rng, len(frames), 480, 640)).astype(np.uint16)
    for j, i in enumerate(frames):
        coarse = rng.uniform(size=(30, 40, 3))
        color = np.repeat(np.repeat(coarse, 16, axis=0), 16, axis=1)
        color = np.clip(color + 0.05 * rng.standard_normal(color.shape), 0, 1)
        Image.fromarray((255 * color).astype(np.uint8), "RGB").save(scene / "color" / f"{i}.jpg")
        Image.fromarray(depth_mm[j]).save(scene / "depth" / f"{i}.png")
    k = np.array([[577.0, 0, 319.5, 0], [0, 577, 239.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    np.savetxt(scene / "intrinsic" / "intrinsic_color.txt", k)
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, t in enumerate(np.linspace(0.0, 1.0, n)):
        a = 0.3 * t
        extr[i, :3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
        extr[i, :3, 3] = [1.2 * t, 0.0, 0.2 * t]
    np.save(scene / "extrinsics.npy", extr)
    (root / "test_idx.txt").write_text(f"{key}\n")
    return key


def fvt_cli_run():
    """``main +experiment=scannet/fvt mode=test`` on one ScanNet-layout
    scene with the 10-view evaluation index, 10 context views, 5 views a
    trunk chunk; stats, dumps and launches checked as in serving."""
    from freesplat_tpu_torch import main as M

    index = ROOT / "assets" / "evaluation_index_scannet_10views.json"
    entry = next(iter(json.loads(index.read_text()).values()))
    views = len(entry["target"]) + len(entry.get("extrapolation", []))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        key = write_scannet_scene(tmp / "scannet", index)
        out = tmp / "out"
        reset_launch_counts()
        t0 = time.perf_counter()
        M.main(["+experiment=scannet/fvt", "mode=test", f"dataset.roots=[{tmp / 'scannet'}]",
                f"dataset.evaluation_index_path={index}", "dataset.num_context_views=10",
                "test.encode_view_chunk=5", f"test.output_path={out}",
                f"dataset.image_shape=[{H},{W}]",
                "test.render_capacity_factor=8.0", f"loss.lpips.weights_path={lpips_npz()}"],
               device=DEVICE)
        sync()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        stats = json.loads((out / "stats.json").read_text())
        summary = stats["summary"]
        check_test_outputs(out, summary, launches, views, 2, "fvt_cli")  # 10 views, 5 a chunk
        (scene,) = stats["per_scene"]
        if (scene["scene"], scene["num_views"]) != (key, views):
            raise AssertionError(f"fvt_cli scene {scene['scene']} with {scene['num_views']} views")
        contexts = len(list((out / key / "context").glob("*.png")))
        if contexts != 10:
            raise AssertionError(f"fvt_cli dumped {contexts} context frames, want 10")
    log(f"[fvt_cli] {key} through main +experiment=scannet/fvt mode=test: 10 context views in "
        f"chunks of 5, {views} target views ({len(entry.get('extrapolation', []))} "
        f"extrapolation), wall {wall:.2f} s, num_gaussians {scene['num_gaussians']:.0f}, "
        f"interpolation psnr {summary['interpolation_psnr']:.3f}, extrapolation psnr "
        f"{summary['extrapolation_psnr']:.3f}, depth_abs_rel {summary['depth_abs_rel']:.4f}, "
        f"launches {launches}")
    return launches


def fvt_train_run():
    """FVT_STEPS full-width ``fit`` steps of the ``scannet/fvt`` preset
    (nearest-5 sources) on tile-rendered synthetic scenes of 8 context and
    TRAIN_TARGET_VIEWS target views, drawn before the run.  Checks the
    launches of every kernel, the metrics and the moved parameters."""
    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.data.synthetic import SyntheticCfg, synthetic_batches
    from freesplat_tpu_torch.training.lpips import make_lpips
    from freesplat_tpu_torch.training.trainer import TrainCfg, fit, init_state

    cfg = load_config(["+experiment=scannet/fvt", "mode=train", "decoder.capacity_factor=8.0"])
    v_ctx = cfg.dataset.num_context_views
    it = synthetic_batches(SyntheticCfg(image_shape=(H, W), num_context=v_ctx,
                                        num_target=TRAIN_TARGET_VIEWS, renderer="tile",
                                        vary_scene=True, seed=5), device=DEVICE)
    scenes = [next(it) for _ in range(FVT_STEPS)]
    tcfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                    optimizer=cfg.optimizer, log_every=1)
    state = init_state(tcfg, seed=cfg.seed, device=DEVICE)
    lpips = make_lpips(device=DEVICE, seed=LPIPS_SEED)
    params0 = {k: p.detach().clone() for k, p in state["encoder"].named_parameters()}
    logged: list = []
    timings: dict = {}
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = fit(tcfg, state, iter(scenes), FVT_STEPS, lpips=lpips,
                log_fn=lambda step, vals: logged.append((step, vals)), timings=timings)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    want = TRAIN_TARGET_VIEWS * FVT_STEPS
    sums = FVT_STEPS * segment_sums_per_step(cfg, v_ctx, TRAIN_TARGET_VIEWS)
    if DEVICE == "cuda" and launches != {"rasterize_fwd": want, "rasterize_bwd": want,
                                         "gather_rows": 0, "segment_sum": sums,
                                         "plane_sweep": 0}:
        raise AssertionError(f"fvt training launches {launches}, want {want} of each rasterizer "
                             f"kernel and {sums} segment sums")
    if [s for s, _ in logged] != list(range(FVT_STEPS)):
        raise AssertionError(f"fit logged steps {[s for s, _ in logged]}")
    for step, vals in logged:
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"fvt step {step}: non-finite metrics {vals}")
        log(f"[fvt_train] step {step}: " + " ".join(f"{k}={v:.6g}" for k, v in vals.items()))
    moved = sum(not torch.equal(params0[k], p) for k, p in state["encoder"].named_parameters())
    if not moved:
        raise AssertionError("fvt training moved no parameter")
    step_ms = [round(1e3 * sum(x), 2) for x in zip(timings["forward_s"], timings["backward_s"],
                                                    timings["optimizer_s"])]
    log(f"[fvt_train] {FVT_STEPS} steps of {v_ctx} context (nearest-"
        f"{cfg.encoder.num_views - 1} sources) and {TRAIN_TARGET_VIEWS} target views, wall "
        f"{wall:.2f} s; ms per step {step_ms} (forward "
        f"{[round(1e3 * t, 2) for t in timings['forward_s']]}, backward "
        f"{[round(1e3 * t, 2) for t in timings['backward_s']]}); peak memory {peak} B; "
        f"{moved} parameter leaves moved; launches {launches}")
    return launches


def determinism_run():
    """Two ``fit`` runs of DET_STEPS full-width steps (``scannet/2views``,
    8 target views) from one seed: losses and every parameter bit-equal.
    Then the cost of the repair: warm steps in four arms, the gathers'
    backward (``take_rows`` or ``index_select``, whose backward is
    ``index_add_``) crossed with cuDNN (free, or held deterministic as
    ``fit`` holds it), in turns; ``index_select`` with cuDNN free is the
    train step as it was before the repair.  Last, the segment-sum kernel
    vs its plain version on the inputs of one step's launches (bit-equal),
    timed beside the plain version and ``index_add_``.  Returns the
    kernel's (max abs error, per-step ms, plain ms, library ms, bound ms,
    bound by)."""
    import contextlib as _ctx

    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.ops import gather as G
    from freesplat_tpu_torch.training.lpips import make_lpips
    from freesplat_tpu_torch.training.trainer import (
        TrainCfg, deterministic_cudnn, fit, init_state, make_train_step,
    )
    from freesplat_tpu_torch.utils.timing import device_bench

    cfg = load_config(["+experiment=scannet/2views", "mode=train", "decoder.capacity_factor=8.0"])
    tcfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                    optimizer=cfg.optimizer, log_every=1)
    lpips = make_lpips(device=DEVICE, seed=LPIPS_SEED)
    scenes = [make_scene(40 + i, v_tgt=TRAIN_TARGET_VIEWS) for i in range(DET_STEPS)]
    runs = []
    for _ in range(2):
        state = init_state(tcfg, seed=cfg.seed, device=DEVICE)
        losses: list = []
        fit(tcfg, state, iter(scenes), DET_STEPS, lpips=lpips,
            log_fn=lambda step, vals: losses.append(vals["loss"]))
        sync()
        runs.append((losses, {k: p.detach().clone()
                              for k, p in state["encoder"].named_parameters()}))
    (l1, p1), (l2, p2) = runs
    diff = max(float((p1[k] - p2[k]).abs().max()) for k in p1)
    differ = [k for k in p1 if not torch.equal(p1[k], p2[k])]
    log(f"[determinism] two fits of {DET_STEPS} steps from seed {cfg.seed}: losses {l1} and "
        f"{l2}; parameters: largest difference {diff}, {len(differ)} of {len(p1)} leaves differ")
    if l1 != l2 or differ:
        raise AssertionError(f"two seeded fits differ: losses {l1} vs {l2}, leaves {differ[:5]}")
    if torch.backends.cudnn.deterministic:
        raise AssertionError("fit left cuDNN held deterministic")
    # The same two runs outside ``fit``, with cuDNN free to pick any
    # algorithm: they drift apart (printed, not checked).
    step = make_train_step(tcfg, lpips)
    runs = []
    for _ in range(2):
        state = init_state(tcfg, seed=cfg.seed, device=DEVICE)
        for sc in scenes:
            state, _ = step(state, sc)
        sync()
        runs.append({k: p.detach().clone() for k, p in state["encoder"].named_parameters()})
    free = max(float((runs[0][k] - runs[1][k]).abs().max()) for k in runs[0])
    log(f"[determinism] the same with cuDNN's algorithms left free: largest parameter "
        f"difference {free}, {sum(not torch.equal(runs[0][k], runs[1][k]) for k in runs[0])} "
        f"leaves differ")

    holder = {"state": init_state(tcfg, seed=cfg.seed, device=DEVICE)}

    @_ctx.contextmanager
    def index_select_gathers():
        """Inside, ``take_rows`` is plain ``index_select`` (backward
        ``index_add_``, float atomics): the gather it replaced."""
        G._TakeRows.apply = staticmethod(lambda x, index: x.index_select(0, index))
        try:
            yield
        finally:
            del G._TakeRows.apply  # back to autograd.Function's own

    arms = [(g, c) for g in ("index_select", "take_rows") for c in ("free", "deterministic")]

    def steps(arm, timed=True):
        gathers, cudnn = arm
        ms = []
        with (index_select_gathers() if gathers == "index_select" else _ctx.nullcontext()), \
                (deterministic_cudnn() if cudnn == "deterministic" else _ctx.nullcontext()):
            for sc in scenes if timed else scenes[:1]:
                sync()
                t0 = time.perf_counter()
                holder["state"], _ = step(holder["state"], sc)
                sync()
                ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    for arm in arms:
        steps(arm, timed=False)  # warm
    turns: dict = {arm: [] for arm in arms}
    order = (arms + arms[::-1]) * DET_TURNS
    for arm in order:
        turns[arm] += steps(arm)
    med = {arm: float(np.median(v)) for arm, v in turns.items()}
    base = med[("index_select", "free")]
    for arm in arms:
        log(f"[determinism] warm steps, gathers {arm[0]}, cuDNN {arm[1]}: "
            f"{[round(t, 2) for t in turns[arm]]} median {med[arm]:.2f} ms "
            f"({100 * (med[arm] / base - 1):+.2f} % against index_select with cuDNN free)")
    log(f"[determinism] in turns ({len(order)} turns of {DET_STEPS} steps, the four arms "
        f"forward then backward): the repair (take_rows, cuDNN deterministic) costs "
        f"{100 * (med[('take_rows', 'deterministic')] / base - 1):+.2f} % a warm step; "
        f"take_rows alone {100 * (med[('take_rows', 'free')] / base - 1):+.2f} %, cuDNN "
        f"deterministic alone {100 * (med[('index_select', 'deterministic')] / base - 1):+.2f} %")

    captured: list = []
    own = G.segment_sum

    def capture(src, order, offsets, rows):
        captured.append((src.clone(), order.clone(), offsets.clone(), rows))
        return own(src, order, offsets, rows)

    G.segment_sum = capture
    try:
        with deterministic_cudnn():
            holder["state"], _ = step(holder["state"], scenes[0])
    finally:
        G.segment_sum = own
    err = check_segment_sums(captured, "determinism")
    saved = dict(G.launch_count)
    ms, plain_ms, lib_ms, nbytes = 0.0, 0.0, 0.0, 0
    for src, order, offsets, rows in captured:
        index = torch.empty_like(order)
        index[order] = torch.repeat_interleave(torch.arange(rows, device=order.device),
                                               offsets[1:] - offsets[:-1])
        a = (src, order, offsets, rows)
        ms += device_bench(G.segment_sum, [a], n=20) * 1e3
        plain_ms += cuda_ms(lambda: G.segment_sum_plain(*a), reps=1)
        zeros = torch.zeros((rows, src.shape[1]), device=src.device)
        lib_ms += device_bench(lambda s, i: zeros.index_add_(0, i, s), [(src, index)], n=20) * 1e3
        n, cols = src.shape
        nbytes += n * cols * 4 + n * 8 + (rows + 1) * 8 + rows * cols * 4
    G.launch_count.update(saved)  # timing launches, not the main path's
    ops = sum(s.numel() for s, *_ in captured)
    bound = _bound(nbytes, ops)
    log(f"[determinism] segment_sum: a step's launches take {ms:.4f} ms (device time), plain "
        f"{plain_ms:.2f} ms, index_add_ {lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
        f"{nbytes} B)")
    return err, (ms, plain_ms, lib_ms, *bound)


LEG_STEPS = 3  # lpips_leg --steps (the leg trains one step more)
PROJ_STEPS = 2  # CLI steps of the [projections] run, validating at step 1
PANELS = ("visualize_depth", "visualize_gaussians", "visualize_epipolar_samples",
          "render_projections", "render_cameras")
MANIFEST = ROOT / "tests" / "fixtures" / "timm_tf_efficientnetv2_s_manifest.json"


def timm_state_dict(seed=1) -> dict:
    """A timm ``tf_efficientnetv2_s`` state dict with every key and shape of
    the 774-key manifest, drawn from ``seed`` (no pretrained file ships):
    fan-in scaled convs, BN statistics near 1, int64 counters."""
    import torch

    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in json.loads(MANIFEST.read_text()).items():
        if not shape:
            sd[k] = torch.zeros((), dtype=torch.int64)
        elif k.endswith(".weight") and len(shape) == 4:
            sd[k] = torch.from_numpy((rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:])))
                                     .astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        elif k.endswith(".weight"):
            sd[k] = torch.from_numpy(rng.uniform(0.8, 1.2, shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))
    return sd


def convert_cli(args) -> dict:
    """``python -m freesplat_tpu_torch.scripts.convert_weights verify ...`` in a
    process of its own; its exit code must be 0.  Returns the report."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "freesplat_tpu_torch.scripts.convert_weights",
                          "verify", *args, "--device", DEVICE], cwd=ROOT, capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise AssertionError(f"convert_weights verify {args[0]} exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    report = json.loads(Path(f"{args[2]}.verify.json").read_text())
    values = ([v for s in report.get("scales", []) for v in (s["mean"], s["std"])]
              + report.get("distances", []))
    finite = report.get("finite", True) and all(s["finite"] for s in report.get("scales", []))
    if not (finite and values and all(math.isfinite(v) for v in values)):
        raise AssertionError(f"convert_weights verify {args[0]}: report {report}")
    log(f"[weights] convert_weights verify {args[0]}: exit 0 in "
        f"{time.perf_counter() - t0:.2f} s; "
        + (f"scales {[(s['shape'][-1], round(s['mean'], 4), round(s['std'], 4)) for s in report['scales']]}"
           if args[0] == "backbone" else f"distances {[round(d, 5) for d in report['distances']]}"))
    return report


def weights_phase():
    """Weights in the reference's torch layouts: a timm-layout .pth from the
    manifest and an ``lpips``-layout .pth (``lpips_leg.synthesize_lpips_pth``)
    through ``convert_weights verify``; the converted backbone grafted into
    a ``scannet/2views`` encoder (``load_backbone_npz``) serves one scene
    through ``run_test``, scored with LPIPS read once from the .npz and
    once from the .pth (equal metrics); a strict conversion refuses an
    extra key.  Returns the launches of the two served runs."""
    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.evaluation.harness import run_test
    from freesplat_tpu_torch.models.encoder import make_encoder
    from freesplat_tpu_torch.scripts.convert_weights import load_backbone_npz, load_tree_npz
    from freesplat_tpu_torch.scripts.lpips_leg import synthesize_lpips_pth
    from freesplat_tpu_torch.training.lpips import load_lpips_params, make_lpips
    from freesplat_tpu_torch.utils.flax_bridge import jax_variables_to_torch
    from freesplat_tpu_torch.utils.torch_convert import convert_efficientnetv2_s

    sd = timm_state_dict()
    extra = dict(sd, **{"blocks.0.0.mystery.weight": torch.zeros(3, 3)})
    try:
        convert_efficientnetv2_s(extra)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("strict conversion accepted an unmapped key")
    if "mystery" not in refusal:
        raise AssertionError(f"strict conversion refused another key: {refusal}")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        timm_pth, timm_npz = tmp / "effnetv2s.pth", tmp / "effnetv2s.npz"
        lpips_pth, lpips_npz_path = tmp / "lpips.pth", tmp / "lpips.npz"
        torch.save(sd, timm_pth)
        synthesize_lpips_pth(lpips_pth)
        convert_cli(["backbone", str(timm_pth), str(timm_npz)])
        convert_cli(["lpips", str(lpips_pth), str(lpips_npz_path)])

        cfg = load_config(["+experiment=scannet/2views", "mode=test",
                           f"test.output_path={tmp / 'out'}", "test.render_capacity_factor=8.0"])
        encoder = make_encoder(cfg.encoder, device=DEVICE, seed=cfg.seed)
        load_backbone_npz(encoder, str(timm_npz))
        want = jax_variables_to_torch(load_tree_npz(str(timm_npz)))
        for k, v in encoder.backbone.state_dict().items():
            if not torch.equal(v.cpu(), want[k]):
                raise AssertionError(f"[weights] grafted backbone {k} differs from the file")
        scene = make_scene(21)
        summaries = {}
        for form, path in (("npz", lpips_npz_path), ("pth", lpips_pth)):
            lpips = make_lpips(load_lpips_params(str(path)), device=DEVICE)
            reset_launch_counts()
            t0 = time.perf_counter()
            summaries[form] = run_test(cfg, batches=iter([scene]), state=encoder.state_dict(),
                                       lpips=lpips, device=DEVICE)
            wall = time.perf_counter() - t0
            launches[form] = launch_counts()
            views = scene["target"]["image"].shape[1]
            if DEVICE == "cuda" and launches[form] != {"rasterize_fwd": views, "rasterize_bwd": 0,
                                                        "gather_rows": 0, "segment_sum": 0,
                                                        "plane_sweep": 1}:
                raise AssertionError(f"[weights] launches {launches[form]} for {views} views")
            summary = summaries[form]
            if not all(math.isfinite(v) for v in summary.values()) or summary["dropped_instances"]:
                raise AssertionError(f"[weights] served scene with LPIPS from the .{form}: {summary}")
            log(f"[weights] served scene (converted backbone, LPIPS from the .{form}): wall "
                f"{wall:.2f} s, psnr {summary['psnr']:.4f}, ssim {summary['ssim']:.4f}, lpips "
                f"{summary['lpips']:.6f}, gaussians {summary['num_gaussians']:.0f}, dropped "
                f"{summary['dropped_instances']:.0f}")
    if summaries["npz"]["lpips"] != summaries["pth"]["lpips"]:
        raise AssertionError(f"[weights] LPIPS from the .npz {summaries['npz']['lpips']} != from "
                             f"the .pth {summaries['pth']['lpips']}")
    log(f"[weights] LPIPS equal from either file; strict conversion of an extra key: {refusal}")
    return {"weights_serve": {k: launches["npz"][k] + launches["pth"][k] for k in launches["npz"]}}


def lpips_leg_run():
    """``scripts/lpips_leg.py --steps LEG_STEPS --image-shape 384,512`` (the
    synthesized ``lpips``-layout .pth through the conversion CLI, then
    ``main`` with MSE + 0.05 LPIPS from step 0): launches by path, finite
    ``loss_lpips`` on every step, the warm step's split and the peak bytes
    from ``torch.cuda.memory_stats``; the backward kernel held against its
    plain version on the first backward launch's own cotangent (and the
    forward bit-equal on its inputs)."""
    from freesplat_tpu_torch import main as M
    from freesplat_tpu_torch.scripts import lpips_leg

    timings: dict = {}
    own_fit = M.fit
    M.fit = functools.partial(own_fit, timings=timings)
    stats: dict = {}

    def leg(argv, device):
        stats.update(lpips_leg.main(argv, device=device))

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)  # the trainer logs under outputs/local
        try:
            with counted_main("lpips_leg") as run, recorded_renders() as rec:
                draws, vals, paths, _, wall = run(
                    ["--steps", str(LEG_STEPS), "--image-shape", f"{H},{W}", "--out",
                     str(tmp / "leg"), "decoder.capacity_factor=8.0", "trainer.log_every=1"],
                    entry=leg)
        finally:
            os.chdir(cwd)
            M.fit = own_fit
        metrics = [json.loads(line) for line in
                   (tmp / "leg" / "metrics_tail.jsonl").read_text().splitlines()]
    from freesplat_tpu_torch.config.config import load_config

    steps = LEG_STEPS + 1
    targets = 2  # the default config's synthetic_num_targets
    sums = segment_sums_per_step(load_config(["dataset.name=synthetic"]), 2, targets)
    # The leg caches one synthetic batch: its 2 context and 2 target views
    # are rendered once, at the first draw.
    want = {"lpips_leg_data": {"rasterize_fwd": 4, "rasterize_bwd": 0, "segment_sum": 0},
            "lpips_leg_train": {"rasterize_fwd": targets * steps, "rasterize_bwd": targets * steps,
                                "segment_sum": sums * steps}}
    got = {p: {k: v.get(k, 0) for k in ("rasterize_fwd", "rasterize_bwd", "segment_sum")}
           for p, v in paths.items() if p in want}
    if DEVICE == "cuda" and (got != want or vals):
        raise AssertionError(f"lpips_leg launches {paths}, want {want} ({draws} batches drawn, "
                             f"{vals} validations)")
    if [m["step"] for m in metrics] != list(range(steps)):
        raise AssertionError(f"lpips_leg logged steps {[m['step'] for m in metrics]}")
    for m in metrics:
        if (not all(math.isfinite(v) for v in m.values()) or not m.get("loss_lpips")
                or m["dropped_instances"] != 0):
            raise AssertionError(f"lpips_leg step {m['step']}: {m}")
    step_ms = [1e3 * sum(x) for x in zip(timings["forward_s"], timings["backward_s"],
                                         timings["optimizer_s"])]
    split = {k: float(np.median([1e3 * t for t in timings[k][1:]]))
             for k in ("forward_s", "backward_s", "optimizer_s")}
    peak = stats.get("allocated_bytes.all.peak", 0)
    if DEVICE == "cuda" and not peak:
        raise AssertionError("lpips_leg: no peak bytes in torch.cuda.memory_stats")
    log(f"[lpips_leg] --steps {LEG_STEPS} --image-shape {H},{W}: {steps} steps of {targets} target "
        f"views, wall {wall:.2f} s; ms per step {[round(t, 2) for t in step_ms]}, warm median "
        f"{float(np.median(step_ms[1:])):.2f} (forward {split['forward_s']:.2f}, backward "
        f"{split['backward_s']:.2f}, optimizer {split['optimizer_s']:.2f}); peak "
        f"{peak} B (allocated_bytes.all.peak); loss_lpips "
        f"{[round(m['loss_lpips'], 6) for m in metrics]}; launches {paths}")
    bwd = rec["bwd"][0]
    errs = re10k_view_checks(bwd[:4], "lpips_leg", bwd)
    return {"lpips_leg_data": paths["lpips_leg_data"], "lpips_leg": paths["lpips_leg_train"]}, errs


def projections_run():
    """``main +experiment=scannet/2views`` on the tile-rendered synthetic
    stream (8 target views) for PROJ_STEPS steps with
    ``trainer.val_save_projections=true`` and a validation at step 1: the
    five panels written, the validation's and each panel's ms (the
    epipolar panel's peak memory beside it) and launches by path (the
    validation: one forward a target view and 3 for the projections).
    Then, at the first projection view of the validated Gaussians: the
    rasterizer's ``dropped`` and instances at the default capacity
    (``return_stats``, all three views; printed, not gated: validation
    renders the projections at that capacity, as the JAX package does),
    the forward kernel bit-equal to plain, and its device time beside its
    bound."""
    import torch
    from PIL import Image

    from freesplat_tpu_torch.models import render_extras as RE
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.ops.rendering import preprocess_gaussians
    from freesplat_tpu_torch.training import validation as V
    from freesplat_tpu_torch.utils.timing import device_bench

    panel_ms: dict = {}
    captured: dict = {}
    own = {name: getattr(V, name) for name in (*PANELS, "validation_step")}

    def timed(name):
        def fn(*a, **kw):
            sync()
            if name == "visualize_epipolar_samples" and DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = own[name](*a, **kw)
            sync()
            panel_ms[name] = 1e3 * (time.perf_counter() - t0)
            if name == "visualize_epipolar_samples" and DEVICE == "cuda":
                panel_ms["epipolar_peak_bytes"] = torch.cuda.max_memory_allocated()
            if name == "render_projections":
                captured["gaussians"] = a[0]
            return out
        return fn

    for name in own:
        setattr(V, name, timed(name))
    args = ["+experiment=scannet/2views", "dataset.name=synthetic",
            "dataset.synthetic_renderer=tile", "dataset.synthetic_num_targets=8",
            "decoder.capacity_factor=8.0", f"dataset.image_shape=[{H},{W}]",
            f"trainer.max_steps={PROJ_STEPS}", "trainer.val_check_interval=1",
            "trainer.val_save_projections=true", "trainer.log_every=1",
            f"loss.lpips.weights_path={lpips_npz()}"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            with counted_main("proj") as run:
                draws, vals, paths, _, wall = run(
                    args + [f"checkpointing.output_dir={tmp / 'ckpt'}"])
        finally:
            os.chdir(cwd)
            for name, fn in own.items():
                setattr(V, name, fn)
        local = tmp / "outputs" / "local"
        pngs = {s: (local / f"val_0000001{s}.png").exists() for s in
                ("", "_depth", "_gaussians", "_epipolar", "_projections", "_cameras")}
        sizes = {}
        for suffix in (s for s in pngs if pngs[s]):
            with Image.open(local / f"val_0000001{suffix}.png") as im:
                sizes[suffix] = im.size
    if not all(pngs.values()):
        raise AssertionError(f"[projections] PNGs missing: {pngs}")
    want = {"proj_data": {"rasterize_fwd": 10 * draws, "rasterize_bwd": 0},
            "proj_train": {"rasterize_fwd": 8 * PROJ_STEPS, "rasterize_bwd": 8 * PROJ_STEPS},
            "proj_val": {"rasterize_fwd": 8 + 3, "rasterize_bwd": 0}}
    got = {p: {k: v.get(k, 0) for k in ("rasterize_fwd", "rasterize_bwd")} for p, v in paths.items()}
    if DEVICE == "cuda" and (got != want or vals != 1):
        raise AssertionError(f"[projections] launches {got}, want {want} ({draws} batches drawn, "
                             f"{vals} validations)")
    log(f"[projections] main +experiment=scannet/2views, {PROJ_STEPS} steps, "
        f"trainer.val_save_projections=true: wall {wall:.2f} s; validation "
        f"{panel_ms['validation_step']:.2f} ms, of which panels ms: depth "
        f"{panel_ms['visualize_depth']:.2f}, gaussians {panel_ms['visualize_gaussians']:.2f}, "
        f"epipolar {panel_ms['visualize_epipolar_samples']:.2f} (peak "
        f"{panel_ms.get('epipolar_peak_bytes', 0)} B), projections "
        f"{panel_ms['render_projections']:.2f}, cameras {panel_ms['render_cameras']:.2f}; PNG sizes "
        f"{sizes}; launches {paths}")

    g = captured["gaussians"]
    n = g.means.shape[0]
    capacity = R.render_capacity(n, 3.0)
    views = RE.projection_views(g.means)
    background = torch.zeros(3, device=g.means.device)
    saved = launch_counts()
    stats = []
    with torch.no_grad():
        for extr, width, height, _ in views:
            e, k = RE.orthographic_camera(extr, width, height, 10.0)
            *_, st = R.rasterize(g.means, g.covariances, g.harmonics, g.masked_opacities(), e, k,
                                 (256, 256), background, 0, return_stats=True)
            stats.append((int(st["num_instances"]), int(st["dropped"])))
        e, k = RE.orthographic_camera(*views[0][:3], 10.0)
        screen = preprocess_gaussians(g.means, g.covariances, g.harmonics, g.masked_opacities(),
                                      e, k, (256, 256), 0)
        binning = R.bin_gaussians(screen, (256, 256), capacity)
        inst = R.build_instance_rows(screen, binning)
    fwd_args = (inst, binning.tile_start, binning.tile_count, 256 // 16)
    err, pairs, _, plain_ms = compare_forward(fwd_args)
    ms = device_bench(R.composite_tiles_fwd, [fwd_args], n=20) * 1e3
    _restore_launch_counts(saved)  # comparison launches, not the main path's
    k_rows = inst.shape[0]
    num_tiles = binning.tile_start.shape[0]
    evaluated, blended, stopped = pairs
    bound = _bound(k_rows * 40 + num_tiles * 8 + num_tiles * 256 * (5 + 1) * 4,
                   blended * FLOPS_PER_PAIR + stopped * FLOPS_PER_PAIR_STOP
                   + (evaluated - blended - stopped) * FLOPS_PER_PAIR_CUT)
    count = binning.tile_count.long()
    log(f"[projections] the 3 projection views of {n} Gaussians at 256x256, capacity {capacity} "
        f"(factor 3.0): (instances, dropped) {stats}; view 0 (looking down x): forward kernel vs "
        f"plain max_err {err} (walk equal); {k_rows} instance rows, {num_tiles} tiles, instances "
        f"a tile max {int(count.max())} mean {float(count.float().mean()):.1f}, "
        f"{int((count >= R.MAX_TILE_INSTANCES).sum())} at the {R.MAX_TILE_INSTANCES} cap; deepest z "
        f"{float(inst[:, 9].max()):.2f}")
    log(f"[time] projection view: forward kernel {ms:.4f} ms (device time), plain {plain_ms:.2f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]}; {evaluated} pairs evaluated, {blended} blended, "
        f"{stopped} terminating)")
    return {"proj_data": paths["proj_data"], "proj_train": paths["proj_train"],
            "proj_val": paths["proj_val"]}, err, (ms, plain_ms, *bound)


MULTI_STEPS = 3  # [multi]: CLI steps with and without the world-1 group
MULTI_SPLIT, MULTI_RANK = 4, 3  # [multi]: the slab split; its slab held against plain
MULTI_TIMEOUT = 600  # s, the torchrun child of [multi]


def multi_run():
    """``[multi]``: the multi-device paths, in a child launched by
    ``torchrun --nproc_per_node 1`` (a world-1 group: NCCL on the card),
    which runs ``multi_worker`` and writes its results to a JSON file.
    Returns the child's launches by path (``multi_*``, ``sharded_render``,
    ``whole_scene_sharded``) and its numbers."""
    import torch

    if DEVICE == "cuda":
        torch.cuda.empty_cache()  # the child needs the card's memory
    settings = {"DEVICE": DEVICE, "H": H, "W": W, "WS_VIEWS": WS_VIEWS,
                "WS_TARGETS": WS_TARGETS, "WS_DEPTH": WS_DEPTH}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "multi.json"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nnodes", "1",
               "--nproc_per_node", "1", str(ROOT / "chip_smoke.py"), "--multi-worker", str(out),
               "--settings", json.dumps(settings)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=MULTI_TIMEOUT)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            if line.startswith("["):  # the child's tagged lines
                log(line)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError(f"[multi] torchrun child exited {proc.returncode}:\n"
                                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        res = json.loads(out.read_text())
    log(f"[multi] torchrun child (world size 1) took {wall:.2f} s")
    return res


def multi_worker(out_path: str, settings: dict) -> int:
    """The ``[multi]`` child, one rank of a torchrun launch: training
    through ``main`` without a group and then with ``trainer.devices=auto``
    (the launch's group), the sharded render's slabs, the whole-scene
    pipeline and the scaling bench under that group; writes the launches
    by path and the numbers to ``out_path``."""
    import torch.distributed as dist
    from freesplat_tpu_torch.parallel import distributed as D
    from freesplat_tpu_torch.parallel import scaling_bench

    globals().update(settings)
    res: dict = {"paths": {}}
    res["train"] = multi_train(res["paths"])
    group = D.make_group("auto")
    if group is None or dist.get_world_size(group) != 1:
        raise AssertionError(f"[multi] the launch's group is {group}")
    res["sharded_render"] = multi_sharded_render(group, res["paths"])
    res["whole_scene"] = multi_whole_scene(group, res["paths"])
    reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        res["scaling"] = scaling_bench.main(
            ["--height", str(H), "--width", str(W), "--reps", "4"], device=DEVICE)
    for line in text.getvalue().splitlines():
        log(f"[multi] scaling_bench: {line}")
    Path(out_path).write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def multi_train(paths: dict) -> dict:
    """``main`` trains MULTI_STEPS steps (``scannet/2views`` on the
    tile-rendered synthetic stream, 8 targets, capacity factor 8.0, MSE +
    0.05 LPIPS) with ``FREESPLAT_DISTRIBUTED=0`` (no group), then with
    ``trainer.devices=auto`` under the launch: every logged metric but the
    rate must be equal, bit for bit (an all-reduce over one rank and a
    division by 1 are exact); launches by path of the group's run."""
    lpips_path = lpips_npz()
    args = ["+experiment=scannet/2views", "dataset.name=synthetic",
            "dataset.synthetic_renderer=tile", "dataset.synthetic_num_targets=8",
            "decoder.capacity_factor=8.0", f"dataset.image_shape=[{H},{W}]",
            f"trainer.max_steps={MULTI_STEPS}", "trainer.log_every=1",
            "trainer.val_check_interval=1000", "checkpointing.every_n_train_steps=1000",
            f"loss.lpips.weights_path={lpips_path}", "trainer.devices=auto"]
    runs = {}
    cwd = os.getcwd()
    for label, forbid in (("no group", True), ("world-1 group", False)):
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            if forbid:
                os.environ["FREESPLAT_DISTRIBUTED"] = "0"
            try:
                with counted_main("multi") as run:
                    draws, _, by_path, text, wall = run(args + [f"checkpointing.output_dir={tmp}"])
            finally:
                os.environ.pop("FREESPLAT_DISTRIBUTED", None)
                os.chdir(cwd)
            metrics = [json.loads(line) for line in
                       (Path(tmp) / "outputs/local/metrics.jsonl").read_text().splitlines()]
        runs[label] = (metrics, by_path, text, wall, draws)
    (m0, _, t0, w0, _), (m1, by_path, t1, w1, draws) = runs["no group"], runs["world-1 group"]
    if "torch.distributed: process 0/1" not in t1 or "torch.distributed" in t0:
        raise AssertionError("[multi] the group run did not take the launch's group, or the "
                             "plain run did")
    strip = [{k: v for k, v in m.items() if k not in ("steps_per_s", "time")} for m in m0 + m1]
    if strip[:len(m0)] != strip[len(m0):] or len(m0) != MULTI_STEPS:
        raise AssertionError(f"[multi] the world-1 group's steps differ from the plain ones:\n"
                             f"{strip[:len(m0)]}\n{strip[len(m0):]}")
    want = {"multi_data": {"rasterize_fwd": 10 * draws, "rasterize_bwd": 0},
            "multi_train": {"rasterize_fwd": 8 * MULTI_STEPS, "rasterize_bwd": 8 * MULTI_STEPS},
            "multi_val": {"rasterize_fwd": 0, "rasterize_bwd": 0}}
    got = {p: {k: c.get(k, 0) for k in ("rasterize_fwd", "rasterize_bwd")}
           for p, c in by_path.items()}
    if DEVICE == "cuda" and got != want:
        raise AssertionError(f"[multi] training launches {got}, want {want}")
    paths.update(by_path)
    ms = {label: [round(1e3 / m["steps_per_s"], 2) for m in r[0]] for label, r in runs.items()}
    log(f"[multi] train: {MULTI_STEPS} CLI steps, losses {[m['loss'] for m in m1]} with the "
        f"world-1 group, bit-equal to the steps with no group (every logged metric); ms a "
        f"logged step (data draw + step) {ms['no group']} with no group, "
        f"{ms['world-1 group']} with the group; walls {w0:.2f} s and {w1:.2f} s; launches "
        f"{by_path}")
    return {"loss": [m["loss"] for m in m1], "ms": ms}


def multi_sharded_render(group, paths: dict) -> dict:
    """At the 384x512 train view (the seeded ``scannet/2views`` encoder's
    Gaussians of ``make_scene(10)``, target view 0, capacity factor 8.0):
    ``render_slab`` at each rank of a MULTI_SPLIT-way split, the slabs
    side by side bit-equal to ``rasterize`` (color, depth, alpha) with
    nothing dropped; ``rasterize_sharded`` under the world-1 group equal
    to ``rasterize`` in value and gradient, bit for bit; slab MULTI_RANK's
    kernels against plain (forward bit-equal, backward within TOL_GRAD
    scaled) and timed beside the whole view's."""
    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.models.encoder import make_encoder
    from freesplat_tpu_torch.ops import rasterizer as R
    from freesplat_tpu_torch.ops.rendering import preprocess_gaussians
    from freesplat_tpu_torch.parallel.sharded_render import (
        rasterize_sharded, render_slab, slab_capacity,
    )

    cfg = load_config(["+experiment=scannet/2views", "mode=train", "decoder.capacity_factor=8.0"])
    encoder = make_encoder(cfg.encoder, device=DEVICE, seed=cfg.seed)
    scene = make_scene(10, v_tgt=TRAIN_TARGET_VIEWS)
    ctx = {k: torch.from_numpy(np.asarray(scene["context"][k])).to(DEVICE) for k in VIEW_KEYS}
    tgt = {k: torch.from_numpy(np.asarray(scene["target"][k])).to(DEVICE) for k in VIEW_KEYS}
    with torch.no_grad():
        g = encoder(ctx)["gaussians"]
    near = tgt["near"][0, 0]
    extr = tgt["extrinsics"][0, 0].clone()
    extr[:3, 3] = extr[:3, 3] / near  # the decoder's 1/near rescale
    leaves = [g.means[0] / near, g.covariances[0] / (near * near), g.harmonics[0],
              g.masked_opacities()[0]]
    view = (extr, tgt["intrinsics"][0, 0], (H, W), torch.zeros(3, device=DEVICE), 2)
    n = leaves[0].shape[0]
    cap = R.render_capacity(n, 8.0)
    with torch.no_grad():
        whole = R.rasterize(*leaves, *view, capacity=cap, return_stats=True)
        screen = preprocess_gaussians(*leaves, extr, view[1], (H, W), 2)
        whole_bin = R.bin_gaussians(screen, (H, W), cap)
        whole_inst = R.build_instance_rows(screen, whole_bin)

    reset_launch_counts()
    with torch.no_grad():
        slabs = [render_slab(screen, r, MULTI_SPLIT, (H, W), slab_capacity(cap, MULTI_SPLIT))
                 for r in range(MULTI_SPLIT)]
    params = [x.detach().clone().requires_grad_() for x in leaves]
    sharded = rasterize_sharded(*params, *view, group=group, capacity=cap, return_stats=True)
    loss = sum((x * (i + 1.0)).sum() for i, x in enumerate(sharded[:3]))
    grads = torch.autograd.grad(loss, params)
    sync()
    launches = launch_counts()
    paths["sharded_render"] = launches
    if DEVICE == "cuda" and (launches["rasterize_fwd"], launches["rasterize_bwd"]) != (
            MULTI_SPLIT + 1, 1):
        raise AssertionError(f"[multi] sharded render launches {launches}")
    dropped = [int(b.dropped) for _, b, _ in slabs]
    assembled = R.finish_image(torch.cat([img for img, _, _ in slabs], dim=1), (H, W), view[3])
    if any(dropped) or int(whole[3]["dropped"]) or int(sharded[3]["dropped"]):
        raise AssertionError(f"[multi] dropped: slabs {dropped}, whole {int(whole[3]['dropped'])}")
    for name, a, b, c in zip(("color", "depth", "alpha"), assembled, whole[:3], sharded[:3]):
        if not (torch.equal(a, b) and torch.equal(c, b)):
            raise AssertionError(f"[multi] {name}: slabs {float((a - b).abs().max())}, "
                                 f"world-1 sharded {float((c - b).abs().max())} from rasterize")
    ref = [x.detach().clone().requires_grad_() for x in leaves]
    out = R.rasterize(*ref, *view, capacity=cap)
    ref_grads = torch.autograd.grad(sum((x * (i + 1.0)).sum() for i, x in enumerate(out)), ref)
    if not all(torch.equal(a, b) for a, b in zip(grads, ref_grads)):
        raise AssertionError("[multi] world-1 rasterize_sharded's gradient differs from "
                             "rasterize's")

    _, binning, inst = slabs[MULTI_RANK]
    local_cols = (W // 16) // MULTI_SPLIT
    col_offset = MULTI_RANK * local_cols
    cmp = compare_tiles(inst, binning, local_cols, seed=4, col_offset=col_offset)
    slab_t = time_kernels(inst, binning, local_cols, cmp, f"slab {MULTI_RANK} of {MULTI_SPLIT} "
                          f"(col_offset {col_offset})", col_offset=col_offset)
    whole_cmp = compare_tiles(whole_inst, whole_bin, W // 16, seed=4)
    whole_t = time_kernels(whole_inst, whole_bin, W // 16, whole_cmp, "whole train view")
    log(f"[multi] sharded render at the train view: {MULTI_SPLIT} slabs of {local_cols} tile "
        f"columns bit-equal to rasterize assembled (color, depth, alpha), dropped {dropped}, "
        f"instances {[int(b.num_instances) for _, b, _ in slabs]} (whole "
        f"{int(whole_bin.num_instances)}); world-1 rasterize_sharded bit-equal in value and "
        f"gradient; slab {MULTI_RANK} (col_offset {col_offset}): forward max_err {cmp[0]:.3g}, "
        f"backward max_err {cmp[1]:.3g} (scaled {cmp[-1]:.3g}); device ms forward "
        f"{slab_t['rasterize_fwd'][0]:.4f} at the slab, {whole_t['rasterize_fwd'][0]:.4f} the "
        f"whole view (bound {slab_t['rasterize_fwd'][2]:.4f} / {whole_t['rasterize_fwd'][2]:.4f}"
        f"), backward {slab_t['rasterize_bwd'][0]:.4f} / {whole_t['rasterize_bwd'][0]:.4f} "
        f"(bound {slab_t['rasterize_bwd'][2]:.4f} / {whole_t['rasterize_bwd'][2]:.4f}); "
        f"launches {launches}")
    return {"slab": slab_t, "whole": whole_t, "errs": [cmp[0], cmp[1]], "dropped": dropped}


def multi_whole_scene(group, paths: dict) -> dict:
    """``encode_whole_scene`` + ``render_whole_scene`` under the world-1
    group on ``whole_scene_bench``'s config (one synthetic scene of
    WS_VIEWS context and WS_TARGETS target views, 15 views a trunk chunk,
    capacity factor 1.0) against ``make_chunked_encode`` + ``render_views``
    with the same weights: equal valid masks, means and rendered color
    and depth within 1e-4 (the same arithmetic is expected, bit for bit),
    nothing dropped; one forward launch a target view."""
    import torch
    from freesplat_tpu_torch.evaluation.harness import make_chunked_encode
    from freesplat_tpu_torch.models.decoder import render_views
    from freesplat_tpu_torch.models.encoder import make_encoder
    from freesplat_tpu_torch.parallel.whole_scene import encode_whole_scene, render_whole_scene
    from freesplat_tpu_torch.scripts.whole_scene_bench import bench_config

    (scene,) = whole_scene_batches(1)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = bench_config(WS_VIEWS, H, W, tmp, WS_DEPTH)
    encoder = make_encoder(dataclasses.replace(cfg.encoder, train_bn=cfg.test.bn_batch_stats),
                           device=DEVICE, seed=cfg.seed)
    dec = dataclasses.replace(cfg.decoder, capacity_factor=cfg.test.render_capacity_factor)
    chunk = cfg.test.encode_view_chunk
    ctx = {k: scene["context"][k] for k in VIEW_KEYS}
    tgt = {k: scene["target"][k] for k in VIEW_KEYS}
    with torch.no_grad():
        ref = make_chunked_encode(encoder, chunk)(ctx)
        ref_out = render_views(dec, ref["gaussians"], tgt["extrinsics"], tgt["intrinsics"],
                               tgt["near"], tgt["far"], (H, W))
        sync()
        timings: dict = {}
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = encode_whole_scene(encoder, ctx, group=group, view_chunk=chunk, timings=timings)
        sync()
        t1 = time.perf_counter()
        color, depth, alpha, dropped = render_whole_scene(
            dec, res["gaussians"], tgt["extrinsics"][0], tgt["intrinsics"][0], tgt["near"][0],
            tgt["far"][0], (H, W), group=group)
        sync()
        t2 = time.perf_counter()
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    paths["whole_scene_sharded"] = launches
    if DEVICE == "cuda" and (launches["rasterize_fwd"], launches["rasterize_bwd"]) != (
            WS_TARGETS, 0):
        raise AssertionError(f"[multi] whole-scene launches {launches}")
    g, rg = res["gaussians"], ref["gaussians"]
    diffs = {
        "means": float((g.means - rg.means).abs().max()),
        "opacities": float((g.opacities - rg.opacities).abs().max()),
        "color": float((color - ref_out.color[0]).abs().max()),
        "depth": float((depth - ref_out.depth[0]).abs().max()),
    }
    if not torch.equal(g.mask, rg.mask) or max(diffs.values()) > 1e-4 or int(dropped.sum()):
        raise AssertionError(f"[multi] whole scene against the chunked encode: masks equal "
                             f"{torch.equal(g.mask, rg.mask)}, max |d| {diffs}, dropped "
                             f"{dropped.tolist()}")
    ms = {k: [round(1e3 * t, 2) for t in v] for k, v in timings.items()}
    log(f"[multi] whole scene ({WS_VIEWS} views, {WS_TARGETS} targets) under the world-1 "
        f"group: encode {1e3 * (t1 - t0):.2f} ms (phases {ms}), render "
        f"{1e3 * (t2 - t1) / WS_TARGETS:.2f} ms a view, peak {peak} B; against the chunked "
        f"encode + render_views max |d| {diffs}, masks equal, {int(g.mask.sum())} Gaussians; "
        f"launches {launches}")
    return {"encode_ms": 1e3 * (t1 - t0), "render_ms": 1e3 * (t2 - t1) / WS_TARGETS,
            "diffs": diffs, "peak": peak}


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


JAX_OVERFIT_CURVE = ROOT / "docs" / "evidence" / "overfit" / "metrics_384x512_r3.jsonl"
JAX_GENERALIZATION = ROOT / "docs" / "evidence" / "generalization" / "stats.json"
# The overfit proof's bar (freesplat_tpu/scripts/overfit_proof.py:9-13):
# test PSNR >= 35 dB with gs_ratio < 1, from 1,000 steps on.
OVERFIT_BAR_DB = 35.0
# The generalization proof's nearest-context leg depends on the data alone:
# the port's 20 held-out scenes against the JAX package's 18.1254 dB.
NEAREST_TOL_DB = 0.05


def _jsonl(path: Path) -> list[dict]:
    return [json.loads(x) for x in Path(path).read_text().splitlines() if x.strip()]


def jax_overfit_curve() -> dict[int, dict]:
    """The JAX package's overfit log by step.  The file holds the proof's
    run, resumed once at step 300, and three short runs logged between;
    the first record of each step is the proof's."""
    curve: dict[int, dict] = {}
    for r in _jsonl(JAX_OVERFIT_CURVE):
        curve.setdefault(r["step"], r)
    return curve


def _keep(keep: Path | None, files: dict) -> None:
    """Copy ``files`` ({name: path}) into the directory ``keep``, if given."""
    import shutil

    if keep is None:
        return
    keep.mkdir(parents=True, exist_ok=True)
    for name, path in files.items():
        if Path(path).exists():
            shutil.copy(path, keep / name)


@contextlib.contextmanager
def proof_dir():
    """A temporary working directory for a proof script, yielded as a
    path: ``main``'s logger writes ``outputs/local/metrics.jsonl`` under
    the working directory (read back by ``logged_curve``)."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            yield Path(tmp)
        finally:
            os.chdir(cwd)


def logged_curve(tmp: Path) -> list[dict]:
    return _jsonl(tmp / "outputs" / "local" / "metrics.jsonl")


def check_overfit(curve: list[dict], stats: dict) -> dict:
    """The overfit proof's gates, in ``[overfit]`` and ``--proof
    overfit``: every logged metric finite and nothing dropped at any
    logged step; the train PSNR at step OVERFIT_GATE_STEP at least
    OVERFIT_MIN_PSNR; the test summary with the JAX evidence's keys,
    finite, nothing dropped and gs_ratio < 1.  Returns the summary."""
    jax_keys = json.loads((JAX_OVERFIT_CURVE.parent / "stats_384x512_r3.json").read_text())[
        "summary"].keys()
    for r in curve:
        if not all(math.isfinite(v) for v in r.values()) or r["dropped_instances"]:
            raise AssertionError(f"[overfit] step {r['step']}: {r}")
    gated = [r["psnr"] for r in curve if r["step"] == OVERFIT_GATE_STEP]
    if gated != [] and gated[0] < OVERFIT_MIN_PSNR:
        raise AssertionError(f"[overfit] train psnr {gated[0]} at step {OVERFIT_GATE_STEP} < "
                             f"{OVERFIT_MIN_PSNR}")
    summary = stats["summary"]
    if summary.keys() != set(jax_keys) | {"dropped_instances"} or len(stats["per_scene"]) != 1:
        raise AssertionError(f"[overfit] stats.json keys {sorted(summary)}")
    if not all(math.isfinite(v) for v in summary.values()) or summary["dropped_instances"] \
            or not summary["gs_ratio"] < 1:
        raise AssertionError(f"[overfit] test summary {summary}")
    return summary


def check_generalization(report: dict) -> dict:
    """The generalization report's gates, in ``[generalization]`` and
    ``--proof generalization``: the JAX evidence's structure (keys, the
    protocol's keys and each leg's) and finite legs.  Returns the legs."""
    jax_report = json.loads(JAX_GENERALIZATION.read_text())
    legs = {k: report[k] for k in ("trained", "untrained", "nearest_context")}
    if report.keys() != jax_report.keys() or report["protocol"].keys() != \
            jax_report["protocol"].keys() or any(report[k].keys() != jax_report[k].keys()
                                                 for k in legs):
        raise AssertionError(f"[generalization] stats.json structure {list(report)}")
    if not all(math.isfinite(v) for leg in legs.values() for v in leg.values()):
        raise AssertionError(f"[generalization] non-finite legs {legs}")
    return legs


def overfit_bf16_depth(ckpt: Path, h: int, w: int) -> dict:
    """The trained checkpoint's encoder in float32 and in bfloat16 on the
    overfit scene's context views (the cached scene the proof trains and
    tests on): ``depth_s-1``'s relative L2 of bfloat16 against float32,
    over both views and in the worse one."""
    import torch
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.data.synthetic import SyntheticCfg, synthetic_batches
    from freesplat_tpu_torch.models.encoder import make_encoder
    from freesplat_tpu_torch.training.checkpoint import latest_step, load_checkpoint

    step = latest_step(str(ckpt))
    state = load_checkpoint(str(ckpt), step, DEVICE)["encoder"]
    cfg = load_config(["mode=test", "dataset.name=synthetic", f"dataset.image_shape=[{h},{w}]",
                       "dataset.synthetic_cache_batches=1"])
    batch = next(synthetic_batches(SyntheticCfg(
        image_shape=(h, w), num_context=cfg.dataset.num_context_views,
        num_target=cfg.dataset.synthetic_num_targets, seed=cfg.data_loader.seed,
        cache_batches=1, renderer=cfg.dataset.synthetic_renderer), device=DEVICE))
    ctx = {k: batch["context"][k] for k in VIEW_KEYS}
    depth = {}
    for dtype in ("float32", "bfloat16"):
        enc_cfg = dataclasses.replace(cfg.encoder, train_bn=cfg.test.bn_batch_stats,
                                      compute_dtype=dtype)
        encoder = make_encoder(enc_cfg, device=DEVICE, seed=cfg.seed)
        encoder.load_state_dict(state, strict=True)
        with torch.no_grad():
            depth[dtype] = encoder(ctx)["depth_s-1"].float()
        del encoder

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    a, b = depth["bfloat16"][0], depth["float32"][0]
    return {"step": step, "rel_l2": rel(a, b), "worst_view": max(rel(x, y) for x, y in zip(a, b)),
            "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all())}


def proof_overfit(steps: int, keep: Path | None) -> None:
    """``scripts/overfit_proof.py`` at 384x512 for ``steps`` steps (its
    default validation and checkpoint interval, 1,000): the train curve
    beside the JAX package's at the same steps
    (``docs/evidence/overfit/metrics_384x512_r3.jsonl``), the test summary,
    then the checkpoint served again under ``encoder.compute_dtype=
    bfloat16`` (its summary, and ``depth_s-1`` against float32).  The
    gates of ``check_overfit``; from 1,000 steps on, the script's bar:
    test PSNR >= 35 dB, gs_ratio < 1."""
    from freesplat_tpu_torch import main as M
    from freesplat_tpu_torch.scripts import overfit_proof

    jax_curve = jax_overfit_curve()
    with proof_dir() as tmp:
        out = tmp / "proof"
        t0 = time.perf_counter()
        overfit_proof.main(["--steps", str(steps), "--out", str(out), "--image-shape",
                            f"{H},{W}"], device=DEVICE)
        wall = time.perf_counter() - t0
        curve = logged_curve(tmp)
        stats = json.loads((out / "test" / "stats.json").read_text())
        t1 = time.perf_counter()
        M.main(["mode=test", "dataset.name=synthetic", f"dataset.image_shape=[{H},{W}]",
                "dataset.synthetic_cache_batches=1", "test.max_scenes=1",
                f"checkpointing.load={out / 'ckpt'}", f"test.output_path={out}/test_bf16",
                "encoder.compute_dtype=bfloat16"], device=DEVICE)
        bf16 = json.loads((out / "test_bf16" / "stats.json").read_text())["summary"]
        bf16_wall = time.perf_counter() - t1
        depth = overfit_bf16_depth(out / "ckpt", H, W)
        _keep(keep, {"metrics.jsonl": tmp / "outputs" / "local" / "metrics.jsonl",
                     "stats.json": out / "test" / "stats.json",
                     "stats_bf16.json": out / "test_bf16" / "stats.json"})
    for r in curve:
        j = jax_curve.get(r["step"])
        log(f"[overfit] step {r['step']}: train psnr {r['psnr']:.4f} (JAX {j['psnr']:.4f})"
            if j else f"[overfit] step {r['step']}: train psnr {r['psnr']:.4f}",
            f"gs_ratio {r['gs_ratio']:.4f} loss {r['loss']:.6g} steps/s {r['steps_per_s']:.3f}")
    log(f"[overfit] {steps} steps at {H}x{W} in {wall:.1f} s (train and test); test summary "
        f"{json.dumps(stats['summary'])}")
    log(f"[overfit] bfloat16 serve of the checkpoint ({bf16_wall:.1f} s): {json.dumps(bf16)}; "
        f"depth_s-1 bfloat16 vs float32 relative L2 {depth['rel_l2']:.4g} (worst view "
        f"{depth['worst_view']:.4g}) at step {depth['step']}")
    summary = check_overfit(curve, stats)
    if not all(math.isfinite(v) for v in bf16.values()) or not depth["finite"] \
            or bf16["dropped_instances"]:
        raise AssertionError(f"[overfit] bfloat16 serve {bf16}, depth {depth}")
    if steps >= 1000 and not (summary["psnr"] >= OVERFIT_BAR_DB and summary["gs_ratio"] < 1):
        raise AssertionError(f"[overfit] test psnr {summary['psnr']} / gs_ratio "
                             f"{summary['gs_ratio']} misses the bar (>= {OVERFIT_BAR_DB}, < 1)")


def proof_generalization(steps: int, scenes: int, keep: Path | None) -> None:
    """``scripts/generalization_proof.py``: ``train --steps steps`` at
    192x256 (3 contexts, 2 targets, a fresh scene each step), then ``eval
    --scenes scenes`` on the held-out stream (seed 99990); the three legs
    beside the JAX package's (``docs/evidence/generalization/stats.json``).
    The gates of ``check_generalization``; the trained leg must beat
    ``nearest_context``, and at JAX's 20 scenes ``nearest_context`` must be
    within NEAREST_TOL_DB of JAX's."""
    from freesplat_tpu_torch.scripts import generalization_proof as G

    jax_report = json.loads(JAX_GENERALIZATION.read_text())
    with proof_dir() as tmp:
        ckpt = tmp / "ckpt"
        t0 = time.perf_counter()
        G.main(["train", "--steps", str(steps), "--ckpt", str(ckpt), "--save-every",
                str(steps)], device=DEVICE)
        t1 = time.perf_counter()
        report = G.main(["eval", "--scenes", str(scenes), "--ckpt", str(ckpt), "--out",
                         str(tmp / "eval")], device=DEVICE)
        t2 = time.perf_counter()
        curve = logged_curve(tmp)
        _keep(keep, {"metrics.jsonl": tmp / "outputs" / "local" / "metrics.jsonl",
                     "stats.json": tmp / "eval" / "stats.json"})
    for r in curve:
        log(f"[generalization] step {r['step']}: train psnr {r['psnr']:.4f} gs_ratio "
            f"{r['gs_ratio']:.4f} loss {r['loss']:.6g} steps/s {r['steps_per_s']:.3f}")
    legs = check_generalization(report)
    log(f"[generalization] train {steps} steps {t1 - t0:.1f} s, eval {scenes} scenes "
        f"{t2 - t1:.1f} s; " + "; ".join(
            f"{k} psnr {v['psnr']:.4f} ssim {v['ssim']:.4f} (JAX {jax_report[k]['psnr']:.4f} / "
            f"{jax_report[k]['ssim']:.4f})" for k, v in legs.items()))
    if not legs["trained"]["psnr"] > legs["nearest_context"]["psnr"]:
        raise AssertionError("[generalization] the trained leg does not beat nearest_context")
    if scenes == jax_report["protocol"]["held_out_scenes"] and abs(
            legs["nearest_context"]["psnr"] - jax_report["nearest_context"]["psnr"]) \
            > NEAREST_TOL_DB:
        raise AssertionError("[generalization] nearest_context differs from JAX's")


OVERFIT_STEPS, OVERFIT_VAL = 200, 100  # [overfit]: overfit_proof --steps --val-every
# The overfit proof's gate on the train PSNR at step 200; the JAX
# package's run logged 39.30 dB there and 35.72 at step 100
# (docs/evidence/overfit/metrics_384x512_r3.jsonl).
OVERFIT_MIN_PSNR = 30.0
OVERFIT_GATE_STEP = 200
GEN_STEPS, GEN_SCENES = 100, 3  # [generalization]: train --steps, eval --scenes
GEN_SHAPE = (192, 256)  # [generalization]: the proof's default --image-shape
SERVE_DUMPS: Path | None = None  # the serving phase's output tree, kept for [offline]


def overfit_run():
    """``scripts/overfit_proof.py --steps 200 --val-every 100`` at 384x512
    in a temporary directory: the gates of ``check_overfit`` (the train
    PSNR at step 200 at least OVERFIT_MIN_PSNR); launches by path
    (``overfit_data``, ``overfit_train``, ``overfit_val``,
    ``overfit_test``); the kernels held against their plain versions at a
    target view of the step-200 Gaussians."""
    from freesplat_tpu_torch.config.config import load_config
    from freesplat_tpu_torch.data.synthetic import SyntheticCfg, synthetic_batches
    from freesplat_tpu_torch.models.encoder import make_encoder
    from freesplat_tpu_torch.scripts import overfit_proof
    from freesplat_tpu_torch.training.checkpoint import load_checkpoint

    jax_curve = {k: r["psnr"] for k, r in jax_overfit_curve().items()}
    with proof_dir() as tmp:
        out = tmp / "proof"
        with counted_main("overfit", test_path=True) as run:
            draws, vals, paths, _, wall = run(
                ["--steps", str(OVERFIT_STEPS), "--val-every", str(OVERFIT_VAL), "--out",
                 str(out), "--image-shape", f"{H},{W}"], entry=overfit_proof.main)
        curve = logged_curve(tmp)
        stats = json.loads((out / "test" / "stats.json").read_text())
        state = load_checkpoint(str(out / "ckpt"), OVERFIT_STEPS, DEVICE)["encoder"]
    steps = [r["step"] for r in curve]
    if steps != list(range(0, OVERFIT_STEPS + 1, 100)):
        raise AssertionError(f"[overfit] logged steps {steps}")
    log(f"[overfit] overfit_proof --steps {OVERFIT_STEPS} --val-every {OVERFIT_VAL} at {H}x{W}: "
        f"wall {wall:.1f} s, {draws} batches drawn, {vals} validations; dropped by step "
        + ", ".join(f"{r['step']}: {r['dropped_instances']:.0f}" for r in curve)
        + "; train psnr by step "
        + ", ".join(f"{r['step']}: {r['psnr']:.3f} (JAX {jax_curve.get(r['step'], math.nan):.3f})"
                    for r in curve)
        + f"; steps/s at the last log {curve[-1]['steps_per_s']:.3f}; test summary "
        f"{json.dumps(stats['summary'])}; launches {paths}")
    cfg = load_config(["dataset.name=synthetic", f"dataset.image_shape=[{H},{W}]",
                       "dataset.synthetic_cache_batches=1"])
    targets = cfg.dataset.synthetic_num_targets
    sums = (OVERFIT_STEPS + 1) * segment_sums_per_step(cfg, 2, targets)
    want = {"overfit_train": {"rasterize_fwd": targets * (OVERFIT_STEPS + 1),
                              "rasterize_bwd": targets * (OVERFIT_STEPS + 1),
                              "segment_sum": sums},
            "overfit_val": {"rasterize_fwd": targets * vals, "rasterize_bwd": 0,
                            "segment_sum": 0},
            "overfit_test": {"rasterize_fwd": targets, "rasterize_bwd": 0, "segment_sum": 0}}
    got = {p: {k: paths[p].get(k, 0) for k in want[p]} for p in want}
    if DEVICE == "cuda" and (got != want or vals != OVERFIT_STEPS // OVERFIT_VAL):
        raise AssertionError(f"[overfit] launches {got}, want {want} ({vals} validations)")
    encoder = make_encoder(dataclasses.replace(cfg.encoder, train_bn=cfg.test.bn_batch_stats),
                           device=DEVICE, seed=cfg.seed)
    encoder.load_state_dict(state, strict=True)
    scene = next(synthetic_batches(SyntheticCfg(
        image_shape=(H, W), num_context=2, num_target=targets, seed=cfg.data_loader.seed,
        cache_batches=1), device=DEVICE))
    saved = launch_counts()
    inst, binning, _, _ = view_inputs(encoder, cfg.decoder.capacity_factor, scene)
    cmp = compare_tiles(inst, binning, W // 16, seed=5)
    for d in _count_dicts():  # comparison launches, not the path's
        d.update({k: v for k, v in saved.items() if k in d})
    log(f"[overfit] target view 0 of the step-{OVERFIT_STEPS} Gaussians: forward max_err "
        f"{cmp[0]:.3g} (bit-equal), backward max_err {cmp[1]:.3g} (scaled {cmp[-1]:.3g}); "
        f"{inst.shape[0]} instances, dropped {int(binning.dropped)}")
    check_overfit(curve, stats)
    return paths, cmp[:2]


def ssim_plain(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """(b, h, w, c) -> (b,) SSIM in float64 numpy: an 11x11 Gaussian
    window (sigma 1.5) over the valid region, skimage's unbiased
    covariances, C1 = 0.01**2 and C2 = 0.03**2 on [0, 1] images."""
    from numpy.lib.stride_tricks import sliding_window_view

    k = np.exp(-0.5 * ((np.arange(11) - 5.0) / 1.5) ** 2)
    k = np.outer(k, k) / k.sum() ** 2
    x, y = np.clip(gt, 0, 1), np.clip(pred, 0, 1)

    def filt(a):  # (b, h, w, c) -> (b, h - 10, w - 10, c)
        return np.einsum("bhwcij,ij->bhwc", sliding_window_view(a, (11, 11), axis=(1, 2)), k)

    n = 121 / 120.0
    mx, my = filt(x), filt(y)
    vx, vy = n * (filt(x * x) - mx * mx), n * (filt(y * y) - my * my)
    vxy = n * (filt(x * y) - mx * my)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = (2 * mx * my + c1) * (2 * vxy + c2) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return ssim.reshape(len(ssim), -1).mean(axis=1)


def nearest_context_plain(batch) -> tuple[float, float]:
    """``_nearest_context_baseline`` recomputed on the host in float64
    numpy: pose distances, the nearest context view, PSNR and
    ``ssim_plain``."""
    ctx = {k: np.asarray(batch["context"][k][0].cpu(), np.float64) for k in ("extrinsics", "image")}
    tgt = {k: np.asarray(batch["target"][k][0].cpu(), np.float64) for k in ("extrinsics", "image")}
    e = np.concatenate([ctx["extrinsics"], tgt["extrinsics"]])
    t, r = e[:, :3, 3], e[:, :3, :3]
    trace = np.einsum("aji,bji->ab", r, r)  # trace(R_a^T R_b)
    dist = np.linalg.norm(t[:, None] - t[None], axis=-1) + np.arccos(
        np.clip((trace - 1) / 2, -1, 1))
    nc = len(ctx["image"])
    pred = ctx["image"][np.argmin(dist[nc:, :nc], axis=1)]
    gt = tgt["image"]
    mse = ((np.clip(gt, 0, 1) - np.clip(pred, 0, 1)) ** 2).mean(axis=(1, 2, 3))
    psnr = -10 * np.log10(np.maximum(mse, 1e-10))
    return float(psnr.mean()), float(ssim_plain(gt, pred).mean())


def generalization_run():
    """``scripts/generalization_proof.py train --steps 100`` at 192x256 (3
    contexts, 2 targets, a fresh tile-rendered scene each step), then
    ``eval --scenes 3``: every leg finite, the report in the JAX
    evidence's structure, ``nearest_context`` equal to
    ``nearest_context_plain`` on the same scenes (1e-4 in dB and SSIM);
    launches by path (``gen_data``, ``gen_train``, ``gen_eval``)."""
    from freesplat_tpu_torch.data.synthetic import SyntheticCfg, synthetic_batches
    from freesplat_tpu_torch.scripts import generalization_proof as G

    with proof_dir() as tmp:
        ckpt = tmp / "ckpt"
        with counted_main("gen") as run:
            draws, vals, paths, _, train_wall = run(
                ["train", "--steps", str(GEN_STEPS), "--ckpt", str(ckpt), "--save-every",
                 str(GEN_STEPS), "--image-shape", "{},{}".format(*GEN_SHAPE)],
                entry=G.main)
        curve = logged_curve(tmp)
        reset_launch_counts()
        t0 = time.perf_counter()
        G.main(["eval", "--scenes", str(GEN_SCENES), "--ckpt", str(ckpt), "--out",
                str(tmp / "eval"), "--image-shape", "{},{}".format(*GEN_SHAPE)], device=DEVICE)
        sync()
        eval_wall = time.perf_counter() - t0
        paths["gen_eval"] = launch_counts()
        saved = json.loads((tmp / "eval" / "stats.json").read_text())
    paths.pop("gen_val")
    views = 3 + 2
    it = synthetic_batches(SyntheticCfg(image_shape=GEN_SHAPE, num_context=3, num_target=2,
                                        seed=G.EVAL_SEED, vary_scene=True, renderer="tile"),
                           device=DEVICE)
    plain = [nearest_context_plain(next(it)) for _ in range(GEN_SCENES)]
    plain = (float(np.mean([p for p, _ in plain])), float(np.mean([s for _, s in plain])))
    legs = check_generalization(saved)
    near = legs["nearest_context"]
    if abs(near["psnr"] - plain[0]) > 1e-4 or abs(near["ssim"] - plain[1]) > 1e-4:
        raise AssertionError(f"[generalization] nearest_context {near} against the plain "
                             f"recomputation {plain}")
    if not all(math.isfinite(v) for r in curve for v in r.values()):
        raise AssertionError("[generalization] non-finite train metrics")
    want = {"gen_data": {"rasterize_fwd": views * draws, "rasterize_bwd": 0},
            "gen_train": {"rasterize_fwd": 2 * (GEN_STEPS + 1),
                          "rasterize_bwd": 2 * (GEN_STEPS + 1)},
            # The baseline's scenes, then each leg's: run_test draws one
            # scene past max_scenes before it stops, as JAX's does.
            "gen_eval": {"rasterize_fwd": GEN_SCENES * views
                         + 2 * ((GEN_SCENES + 1) * views + 2 * GEN_SCENES),
                         "rasterize_bwd": 0}}
    got = {p: {k: paths[p].get(k, 0) for k in want[p]} for p in want}
    if DEVICE == "cuda" and got != want:
        raise AssertionError(f"[generalization] launches {got}, want {want}")
    log(f"[generalization] train --steps {GEN_STEPS} at {GEN_SHAPE[0]}x{GEN_SHAPE[1]}: wall {train_wall:.1f} s, "
        f"train psnr by step " + ", ".join(f"{r['step']}: {r['psnr']:.3f}" for r in curve)
        + f"; eval --scenes {GEN_SCENES}: wall {eval_wall:.1f} s; " + "; ".join(
            f"{k} psnr {v['psnr']:.4f} ssim {v['ssim']:.4f}" for k, v in legs.items())
        + f"; nearest_context recomputed on the host {plain[0]:.4f} / {plain[1]:.4f}; "
        f"launches {paths}")
    return paths


def top_device_ops(prof, n: int = 10) -> tuple[float, float, list]:
    """(device busy ms, the device operations' summed ms, the ``n`` device
    operations with the most device time: (ms, calls, name)) from a
    ``torch.profiler`` session.  Busy is the union of the operations'
    intervals: cuDNN runs some on a stream of its own, so they overlap and
    their sum can exceed the wall time."""
    from torch.autograd import DeviceType

    ops: dict[str, list[float]] = {}
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ops.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(((sum(v), len(v), k) for k, v in ops.items()), reverse=True)[:n]
    return busy / 1e3, sum(sum(v) for v in ops.values()), top


def profile_run():
    """``whole_scene_profile`` at 30 views x 384x512, chunks of 15: a cold
    rep, then a warm one inside ``utils/profiling.trace`` (its phases,
    the device's busy share and the ten device operations with the most
    time; the trace file written); ``profile_stages raster raster_sub
    train`` and ``bench_suite raster encoder train2`` (their lines
    relayed).  Launches by path: ``profile_ws`` (the scene's renders),
    ``profile_stages``, ``bench_suite``."""
    from freesplat_tpu_torch.scripts import bench_suite, profile_stages, whole_scene_profile
    from freesplat_tpu_torch.utils.profiling import trace

    paths = {}
    reset_launch_counts()
    args = whole_scene_profile.parse_args(["--views", str(WS_VIEWS), "--image-shape", f"{H},{W}",
                                           "--chunk", "15", "--device", DEVICE])
    encode, context, timings = whole_scene_profile.setup(args)
    paths["profile_ws"] = launch_counts()
    cold, cold_phases = whole_scene_profile.run_rep(encode, context, timings, args.chunk)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with trace(tmp, enabled=True) as prof:
            warm, warm_phases = whole_scene_profile.run_rep(encode, context, timings, args.chunk)
        trace_s = time.perf_counter() - t0
        files = [(p.name, p.stat().st_size) for p in Path(tmp).iterdir()]
    if not files or not all(size > 0 for _, size in files):
        raise AssertionError(f"[profile] trace directory {files}")
    del encode, context
    busy, summed, top = top_device_ops(prof)
    if DEVICE == "cuda" and not top:
        raise AssertionError("[profile] the trace holds no device operation")
    for label, total, phases in (("cold", cold, cold_phases), ("warm (traced)", warm, warm_phases)):
        if not all(v >= 0 for v in phases.values()):
            raise AssertionError(f"[profile] negative phase in {phases}")
        log(f"[profile] whole_scene_profile {WS_VIEWS} views {H}x{W} chunks of 15, {label}: "
            f"total {total:.3f} s {json.dumps(phases)}")
    log(f"[profile] the traced warm encode: host wall {1e3 * warm:.2f} ms, device busy "
        f"{busy:.2f} ms (idle share {1 - busy / (1e3 * warm):.3f}; the operations' times sum "
        f"to {summed:.2f} ms); trace {files} in {trace_s:.1f} s; the ten device operations "
        f"with the most time:")
    for ms, calls, name in top:
        log(f"[profile]   {ms:9.3f} ms  x{calls:<5d} {name[:100]}")
    reset_launch_counts()
    profile_stages.main(["raster", "raster_sub", "train"], device=DEVICE)
    paths["profile_stages"] = launch_counts()
    reset_launch_counts()
    bench_suite.main(["raster", "encoder", "train2"], device=DEVICE)
    paths["bench_suite"] = launch_counts()
    log(f"[profile] launches {paths}")
    return paths


def offline_run():
    """Offline evaluation: ``compute_metrics`` over the serving phase's
    PNG dumps (each scene's PSNR and SSIM within 1e-4 of
    ``compute_psnr``/``compute_ssim`` on the host over the same PNGs read
    back; ``run_test``'s unquantized numbers printed beside);
    ``generate_evaluation_index`` on a ScanNet-layout scene (the same
    JSON as the generator on the host CPU); ``videoize_index``;
    ``test_splatter`` (24 PNGs and a GIF)."""
    import torch
    from PIL import Image
    from freesplat_tpu_torch.evaluation.metric_computer import _load_frames, compute_scene_metrics
    from freesplat_tpu_torch.scripts import compute_metrics, generate_evaluation_index
    from freesplat_tpu_torch.scripts import test_splatter
    from freesplat_tpu_torch.scripts.generate_video_evaluation_index import videoize_index
    from freesplat_tpu_torch.training.metrics import compute_psnr, compute_ssim

    if SERVE_DUMPS is None:
        raise AssertionError("[offline] the serving phase kept no dumps")
    served = {e["scene"]: e for e in json.loads((SERVE_DUMPS / "stats.json").read_text())[
        "per_scene"]}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            table = compute_metrics.main([f"served={SERVE_DUMPS}"], device=DEVICE)
            metrics_s = time.perf_counter() - t0
            if json.loads((tmp / "outputs" / "metrics" / "metrics.json").read_text()) != table:
                raise AssertionError("[offline] metrics.json differs from the returned table")
        finally:
            os.chdir(cwd)
        rows = []
        for scene_dir in sorted(p for p in SERVE_DUMPS.iterdir() if p.is_dir()):
            card = compute_scene_metrics(scene_dir, device=DEVICE)
            if card is None:  # an FVS scene: no color/ folder, as in JAX
                continue
            preds, gts = (_load_frames(scene_dir / "color", gt=g) for g in (False, True))
            pred = torch.from_numpy(np.stack([preds[k] for k in sorted(preds)]))
            gt = torch.from_numpy(np.stack([gts[k] for k in sorted(preds)]))
            host = (float(compute_psnr(gt, pred).mean()), float(compute_ssim(gt, pred).mean()))
            if abs(card["psnr"] - host[0]) > 1e-4 or abs(card["ssim"] - host[1]) > 1e-4:
                raise AssertionError(f"[offline] {scene_dir.name}: {card} against {host}")
            rows.append((scene_dir.name, card, host, served[scene_dir.name]))
        if not rows or table["served"]["num_frames"] != sum(r[1]["num_frames"] for r in rows):
            raise AssertionError(f"[offline] compute_metrics table {table}")

        index = ROOT / "assets" / "evaluation_index_scannet_10views.json"
        key = write_scannet_scene(tmp / "scannet", index)
        # The index key names the scene with the evaluation split's "_0"
        # suffix; without the list the loader takes the scene's folder.
        (tmp / "scannet" / "test_idx.txt").unlink()
        # A track that turns 0.01 rad and moves 1 cm a frame: the pair
        # overlap crosses the generator's [0.4, 0.8] within 60 frames, so
        # the first context it draws finds a partner.  (On the scene's slow
        # arc no pair qualifies, and the generator walks every frame.)
        poses = tmp / "scannet" / "test" / key[:-2] / "extrinsics.npy"
        extr = np.load(poses)
        for i in range(len(extr)):
            a = 0.01 * i
            extr[i, :3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                               [-math.sin(a), 0, math.cos(a)]]
            extr[i, :3, 3] = [0.01 * i, 0.0, 0.0]
        np.save(poses, extr)
        t0 = time.perf_counter()
        files = [generate_evaluation_index.main(
            [f"dataset.roots=[{tmp / 'scannet'}]", f"test.output_path={tmp / where}"],
            device=device) for where, device in (("card", DEVICE), ("host", "cpu"))]
        index_s = time.perf_counter() - t0
        card_index, host_index = (json.loads(f.read_text()) for f in files)
        if card_index != host_index or len(card_index) != 1 or None in card_index.values():
            raise AssertionError(f"[offline] index {card_index} against the host's {host_index}")
        video = videoize_index({**card_index, **json.loads(
            (ROOT / "assets" / "evaluation_index_scannet_2views.json").read_text())})
        for key, entry in video.items():
            if entry is not None and entry["target"] != list(
                    range(min(entry["context"]), max(entry["context"]) + 1)):
                raise AssertionError(f"[offline] videoized {key}: {entry}")

        t0 = time.perf_counter()
        frames = test_splatter.main(str(tmp / "splatter"), device=DEVICE)
        splatter_s = time.perf_counter() - t0
        pngs = sorted((tmp / "splatter").glob("*.png"))
        gif = Image.open(tmp / "splatter" / "spin.gif")
        if len(pngs) != 24 or getattr(gif, "n_frames", 1) != 24 or not all(
                np.isfinite(f).all() and f.max() > 0.1 for f in frames):
            raise AssertionError(f"[offline] test_splatter wrote {len(pngs)} PNGs, GIF of "
                                 f"{getattr(gif, 'n_frames', 1)} frames")
    for name, card, host, run in rows:
        log(f"[offline] compute_metrics {name}: {card['num_frames']} frames, psnr "
            f"{card['psnr']:.5f} ssim {card['ssim']:.5f} (host over the PNGs {host[0]:.5f} / "
            f"{host[1]:.5f}; run_test's unquantized {run['psnr']:.5f} / {run['ssim']:.5f})")
    log(f"[offline] compute_metrics {metrics_s:.2f} s, table {table}; generate_evaluation_index "
        f"on the card and the host {index_s:.2f} s: {card_index}; videoized "
        f"{sum(e is not None for e in video.values())} entries; test_splatter 24 frames at "
        f"128x128 and spin.gif in {splatter_s:.2f} s")


@contextlib.contextmanager
def phase(name: str):
    """``[phase] <name> start`` / ``ok <seconds>`` around a phase; on an
    exception ``[fail] <name>: <type>: <message>`` and the traceback's
    last frame on standard output, and the exception goes on (the run
    fails)."""
    import traceback

    log(f"[phase] {name} start")
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        log(f"[fail] {name}: {type(e).__name__}: {e}")
        frames = traceback.extract_tb(e.__traceback__)
        if frames:
            f = frames[-1]
            log(f"[fail]   at {f.filename}:{f.lineno} in {f.name}: {f.line}")
        raise
    log(f"[phase] {name} ok {time.perf_counter() - t0:.2f}")


def run_phase(name: str, fn, *args):
    with phase(name):
        return fn(*args)


def main(argv=None) -> int:
    global BASELINE
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on an NVIDIA GPU.")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a directory holding another tree's rasterize_{fwd,bwd}.cu and "
                         "gather_rows.cu, held against this tree's kernels and timed "
                         "beside them")
    ap.add_argument("--proof", choices=["overfit", "generalization"], default=None,
                    help="run one quality proof at its published size instead of the checks")
    ap.add_argument("--steps", type=int, default=1000, help="--proof: training steps")
    ap.add_argument("--scenes", type=int, default=20,
                    help="--proof generalization: held-out scenes")
    ap.add_argument("--keep", type=Path, default=None,
                    help="--proof: copy the curve and stats files into this directory")
    ap.add_argument("--multi-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--settings", default="{}", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    BASELINE = args.baseline
    import torch

    settings = json.loads(args.settings)
    if not torch.cuda.is_available() and settings.get("DEVICE") != "cpu":
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.multi_worker:  # the [multi] phase's torchrun child
        return multi_worker(args.multi_worker, settings)
    card = card_line()
    with phase("build"):
        import freesplat_tpu_torch  # noqa: F401  (sets the precision flags)
        from freesplat_tpu_torch.utils import cuda_build

        log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
            f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"tf32 cudnn {torch.backends.cudnn.allow_tf32}")
        t0 = time.perf_counter()
        names = ["rasterize_fwd", "rasterize_bwd", "gather_rows", "segment_sum", "plane_sweep"]
        cuda_build.build_all(names)
        log(f"[build] {names} in {time.perf_counter() - t0:.2f} s")
        for k in names:
            log(f"[build] {k}: {cuda_build.BUILD_INFO[k]['log']}")
    keep = args.keep.resolve() if args.keep else None  # the proofs change directory
    if args.proof == "overfit":
        run_phase("proof_overfit", proof_overfit, args.steps, keep)
    elif args.proof == "generalization":
        run_phase("proof_generalization", proof_generalization, args.steps, args.scenes, keep)
    else:
        return checks(torch, card)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def checks(torch, card) -> int:
    """Every phase of the checks, in order; the kernels line, the card line
    and the result line."""
    global SERVE_DUMPS
    dumps = tempfile.TemporaryDirectory()
    SERVE_DUMPS = Path(dumps.name)
    errs = [run_phase("kernel_cases", kernel_cases)]
    sweep_err, sweep_t, sweep_2v_t = run_phase("plane_sweep", plane_sweep_phase)
    run_phase("native", native_phase)
    bench_err, bench_t = run_phase("bench_scene", bench_scene)
    errs.append(bench_err)
    serve_launches, serve_err = run_phase("slice", slice_run)
    errs.append(serve_err)
    weights_launches = run_phase("weights", weights_phase)
    ws_launches, ws_err, ws_t = run_phase("whole_scene", whole_scene_run)
    errs.append((ws_err, 0.0))
    fvt_cli_launches = run_phase("fvt_cli", fvt_cli_run)
    train_launches, train_err, timing = run_phase("train", train_run)
    errs.append(train_err)
    depth_launches, depth_bwd_err, _ = run_phase("depth", train_depth_run)
    errs.append((0.0, depth_bwd_err))
    leg_launches, leg_err = run_phase("lpips_leg", lpips_leg_run)
    errs.append(leg_err)
    replica_launches = run_phase("replica", replica_run)
    with tempfile.TemporaryDirectory() as tmp:
        key = run_phase("re10k", re10k_chunks, Path(tmp))
        re10k_launches, re10k_err, re10k_seg_err, _ = run_phase(
            "re10k_train", re10k_train_run, Path(tmp))
        re10k_test_launches, re10k_test_err = run_phase(
            "re10k_test", re10k_test_run, Path(tmp), key)
    errs += [re10k_err, (re10k_test_err, 0.0)]
    gather_err, gather_t = run_phase("gather", gather_phase)
    probe_launches, probe = run_phase("probe", probe_run)
    cli_launches, _ = run_phase("cli", cli_run)
    multi = run_phase("multi", multi_run)
    proj_launches, proj_err, proj_t = run_phase("projections", projections_run)
    errs.append((proj_err, 0.0))
    fvt_train_launches = run_phase("fvt_train", fvt_train_run)
    seg_err, seg_t = run_phase("determinism", determinism_run)
    gen_launches = run_phase("generalization", generalization_run)
    profile_launches = run_phase("profile", profile_run)
    run_phase("offline", offline_run)
    dumps.cleanup()
    overfit_launches, overfit_err = run_phase("overfit", overfit_run)
    errs.append(overfit_err)
    for k, (ms, plain_ms, bound_ms, bound_by) in bench_t.items():
        log(f"[bench] {k} at the bench scene: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")

    ms, plain_ms, bound_ms, bound_by = ws_t
    log(f"[whole_scene] rasterize_fwd at a whole-scene view: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    ms, plain_ms, bound_ms, bound_by = proj_t
    log(f"[projections] rasterize_fwd at a projection view: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    paths = {"serve": serve_launches, "train": train_launches, "train_depth": depth_launches,
             "replica": replica_launches, "probe": probe_launches, **cli_launches,
             **ws_launches, "fvt_cli": fvt_cli_launches, "fvt_train": fvt_train_launches,
             **re10k_launches, "re10k_test": re10k_test_launches, **weights_launches,
             **leg_launches, **proj_launches, **multi["paths"], **overfit_launches,
             **gen_launches, **profile_launches}
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
    ms, plain_ms, lib_ms, bound_ms, bound_by = seg_t
    rows.append({
        "name": "segment_sum",
        "route": "cuda",
        "source": "freesplat_tpu_torch/csrc/segment_sum.cu",
        # No TPU kernel: XLA computes the gathers' backward on the TPU as
        # a deterministic scatter-add, and no pallas_call does it.
        "replaces": None,
        "launches": train_launches["segment_sum"],
        "launches_by_path": {p: c.get("segment_sum", 0) for p, c in paths.items()},
        "max_abs_err": max(seg_err, re10k_seg_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    })
    ms, plain_ms, bound_ms, bound_by = sweep_t
    rows.append({
        "name": "plane_sweep",
        "route": "cuda",
        "source": "freesplat_tpu_torch/csrc/plane_sweep.cu",
        # No TPU kernel: the JAX package sweeps with XLA's gathers.
        "replaces": None,
        "launches": paths["serve"]["plane_sweep"],
        "launches_by_path": {p: c.get("plane_sweep", 0) for p, c in paths.items()},
        "max_abs_err": sweep_err,  # relative to the volume's max abs
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "two_view": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), sweep_2v_t)),
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
