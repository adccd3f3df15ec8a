"""Test harness (reference ``ModelWrapper.test_step`` + ``on_test_end``,
``src/model/model_wrapper.py:305-504``).

Port of ``freesplat_tpu/evaluation/harness.py::run_test``.  Per scene:
timed encoder forward -> chunked rendering of the target views -> PSNR,
SSIM (+ LPIPS under 100 frames), split into interpolation and
extrapolation blocks on FVS scenes -> rendered-depth metrics against the
sensor depth -> frame and depth-colormap dumps, encoded on writer
threads while the next scene runs; then, every file written, the
view-weighted per-scene averages and ``benchmark.json``,
``peak_memory.json`` (the port's own format, ``utils/benchmarker.py``)
and ``stats.json`` under ``test.output_path``.  Without ``batches`` it reads the configured
dataset (``main.make_batches``).  ``test.encode_view_chunk`` encodes a
scene in chunks of views (``make_chunked_encode``, the whole-scene path).
``test.save_ply`` writes each scene's valid Gaussians to
``<scene>/gaussians.ply`` and ``test.save_video`` renders the wobble and
context-interpolation videos (``<scene>/{wobble,interpolation}.gif``, 30
frames each).  ``test.view_shard`` splits each scene's context views
over the ranks of a multi-process launch (torchrun) for the encode
(JAX's ``make_view_sharded_encode``); rank 0 writes the files.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch
from PIL import Image

from ..config.config import RootCfg
from ..models.decoder import render_views
from ..models.encoder import EncoderFreeSplat, make_encoder, sweep_geometry
from ..models.ptf import fuse_views
from ..models.types import Gaussians
from ..models.backbone import synced_batch_norm
from ..parallel.distributed import (
    all_gather_plain, group_rank, make_group, maybe_initialize_distributed, rank_device,
)
from ..training.checkpoint import latest_step, load_checkpoint
from ..training.metrics import compute_psnr, compute_ssim, depth_metrics
from ..utils.benchmarker import Benchmarker
from ..utils.device import resolve_device
from ..utils.flax_bridge import load_flax_variables
from ..utils.ply_export import export_ply
from ..utils.profiling import count, host_array, host_value, span, timed, upload
from ..utils.visualization import depth_to_color
from .video import render_video_interpolation, render_video_wobble

_VIEW_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


# ``timings=``'s keys: (first span, last span[, divisor attribute]).
_ENCODE_TIMINGS = {
    "A_match_s": ("encode.match", "encode.match"),
    "A_geometry_s": ("encode.geometry", "encode.geometry"),
    "B_trunk_s": ("encode.trunk", "encode.trunk"),
    "B_concat_s": ("encode.concat", "encode.concat"),
    "C1_ptf_s": ("encoder.ptf", "encoder.ptf"),
    "C2_head_s": ("encoder.head", "encoder.head"),
}
_SCENE_TIMINGS = {
    "encoder_s": ("encode", "encode"),
    "decoder_s_per_view": ("decode", "decode", "views"),
    "metrics_s": ("scene.metrics", "scene.metrics"),
    "dumps_s": ("scene.readback", "scene.dumps"),
    "ply_s": ("scene.ply", "scene.ply"),
    "video_s": ("scene.video", "scene.video"),
}


def _write_png(array: np.ndarray, path: Path) -> tuple[int, float]:
    """One PNG file as the dumps write it: clipped to [0, 1], times 255,
    truncated to uint8, saved with Pillow's defaults.  Returns the file's
    bytes and the writer's host milliseconds."""
    t0 = time.perf_counter()
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((np.clip(np.asarray(array), 0, 1) * 255).astype(np.uint8)).save(path)
    return path.stat().st_size, 1e3 * (time.perf_counter() - t0)


class _PngWriter:
    """A scene's PNG dumps, encoded on a pool of writer threads while the
    scene loop goes on to the next scene's upload, encode and renders.
    Threads overlap that work because Pillow's PNG encoder and numpy's
    large ufuncs release the GIL.  The pool has one thread a core the
    process may use, less one for the scene loop, and at least one.

    ``submit(unit, files)`` first joins the previous scene's files
    (``wait``), then hands this scene's to the pool: at most two scenes'
    arrays are on the host.  The jobs get numpy arrays only, never a
    tensor.  ``wait()`` joins the outstanding scene's files in a span
    ``dumps.wait`` and counts them, on the calling thread and under that
    scene's unit (the writers record nothing): ``png_hidden`` (the files
    already written when the wait began), and a file each ``png_files``,
    ``png_bytes`` and ``png_ms`` (the writer's host time; attribute
    ``kind``).  It re-raises the first writer error, in submission order.
    ``close()`` lets the files handed over finish and joins the threads."""

    def __init__(self):
        workers = max(1, len(os.sched_getaffinity(0)) - 1)
        self._pool = ThreadPoolExecutor(workers, thread_name_prefix="png-writer")
        self._unit: Any = None
        self._jobs: list[tuple[str, Future]] = []

    def submit(self, unit: Any, files: Iterable[tuple[str, np.ndarray, Path]]) -> None:
        self.wait()
        self._unit = unit
        self._jobs = [(kind, self._pool.submit(_write_png, array, path))
                      for kind, array, path in files]

    def wait(self) -> None:
        jobs, unit = self._jobs, self._unit
        self._jobs = []
        with span("dumps.wait"):
            hidden = sum(f.done() for _, f in jobs)
            results = [(kind, f.result()) for kind, f in jobs]
        if jobs:
            count("png_hidden", hidden, unit=unit)
        for kind, (nbytes, ms) in results:
            count("png_files", 1, unit=unit)
            count("png_bytes", nbytes, unit=unit)
            count("png_ms", ms, kind=kind, unit=unit)

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def make_chunked_encode(
    encoder: EncoderFreeSplat, view_chunk: int | None,
    timings: dict[str, list[float]] | None = None,
    group=None,
    trunk_only: bool = False,
):
    """Whole-scene encode of one scene (batch 1) on one card, ``view_chunk``
    views at a time: ``encode(context) -> results`` as ``encoder(context)``
    returns them (no ``depth_s{i}`` of the lower scales).

    With a process ``group`` the views are split over its ranks: each rank
    runs A and B on its own share (in chunks of ``view_chunk``, default
    the whole share) and all-gathers the matching features after A and
    the trunk outputs after B; the geometry, C1 and C2 run replicated
    (JAX's ``make_view_sharded_encode``).  Batch-statistics BN then
    normalizes each chunk over every rank's chunk (``synced_batch_norm``):
    with one chunk a rank, over the whole scene.
    ``trunk_only`` returns the trunk dict after B (every view's PTF
    inputs) instead.

    Port of ``freesplat_tpu/evaluation/harness.py::make_chunked_encode``:
    A, the matching features of every view, by chunks; then
    ``sweep_geometry`` once over the whole trajectory (nearest-k sources
    among all views); B, the trunk of each chunk (``stage="trunk_chunk"``)
    fed its views' gathered source features; C1, PTF over all views
    (``fuse_views``); C2, the Gaussian head.  The result equals the monolithic encode under
    running-average BN; with batch-statistics BN each chunk is normalized
    with its own statistics, as in JAX.

    The phases are spans: ``encode.match``, ``encode.geometry``, one
    ``encode.trunk`` a chunk (attribute ``chunk``, its first view),
    ``encode.concat``, ``encoder.ptf`` and ``encoder.head``.
    ``timings``, if given, collects each phase's seconds (host clock
    around synchronized device work, ``utils/profiling.py::timed``):
    "A_match_s", "A_geometry_s", "B_trunk_s" (one entry a chunk),
    "B_concat_s", "C1_ptf_s" and "C2_head_s"."""
    cfg = encoder.cfg

    def encode(context: dict[str, torch.Tensor]) -> dict[str, Any]:
        with timed(timings, _ENCODE_TIMINGS):
            return _encode(context)

    def _encode(context):
        images = context["image"]
        b, v, h, w, _ = images.shape
        if b != 1:
            raise ValueError(f"the chunked whole-scene encode takes one scene, got {b}")

        def sub(sl, extra=None):
            d = {k: x[:, sl] for k, x in context.items() if k in _VIEW_KEYS}
            return {**d, **(extra or {})}

        rank, world = group_rank(group)
        if v % world:
            raise ValueError(f"{v} views do not split over {world} ranks")
        lo, hi = rank * (v // world), (rank + 1) * (v // world)
        step = view_chunk or hi - lo
        chunks = [slice(s, min(s + step, hi)) for s in range(lo, hi, step)]
        with span("encode.match"):
            with synced_batch_norm(encoder, group):
                match_bv = torch.cat([encoder(sub(sl), stage="match")["match"]
                                      for sl in chunks], dim=1)
            match_bv = all_gather_plain(match_bv, group, dim=1)
        mh, mw = match_bv.shape[2:4]

        with span("encode.geometry"):
            src_idx, src_T_cur, src_K, cur_invK = sweep_geometry(
                context["extrinsics"][0], context["intrinsics"][0], cfg.num_views, (mh, mw))

        outs = []
        for sl in chunks:
            with span("encode.trunk", chunk=sl.start):
                extra = {
                    "match_src": match_bv[0][src_idx[sl]][None],
                    "src_T_cur": src_T_cur[None, sl],
                    "src_K": src_K[None, sl],
                    "cur_invK": cur_invK[None, sl],
                }
                with synced_batch_norm(encoder, group):
                    outs.append(encoder(sub(sl, extra), stage="trunk_chunk"))
        with span("encode.concat"):
            trunk = {k: all_gather_plain(torch.cat([o[k] for o in outs], dim=1), group, dim=1)
                     for k in outs[0]}
            del outs
        if trunk_only:
            return trunk

        # JAX takes fuse_views_bucketed above 8 views, for XLA's static
        # shapes; here that is fuse_views itself (models/ptf.py).
        with span("encoder.ptf"):
            state = fuse_views(
                trunk["feat_v"][0], trunk["coords_v"][0], trunk["dens_v"][0], trunk["wt_v"][0],
                trunk["depth_v"][0], context["extrinsics"][0], context["intrinsics"][0], (h, w),
                encoder.fuse.gru,
            )

        g, scales, rotations = encoder.fuse.head(state, context["intrinsics"][0, 0], (h, w))
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

    return encode


def run_test(
    cfg: RootCfg,
    batches: Iterable[dict] | None = None,
    state: dict | None = None,
    max_scenes: int | None = None,
    lpips: torch.nn.Module | None = None,
    device: str | torch.device = "cuda",
    timings: dict[str, list[float]] | None = None,
) -> dict[str, float]:
    """Evaluate ``batches`` (dicts of numpy arrays or tensors with batch 1:
    ``scene``, ``context`` and ``target`` views, the target optionally with
    sensor ``depth`` and ``test_fvs``; default the configured dataset's
    test stage, 4 scenes of a synthetic one), write the dumps and stats
    files under ``test.output_path`` and return the view-weighted
    per-scene averages.

    ``state``: flax variables ({"params", "batch_stats"}, bridged) or the
    port's state_dict; None takes the encoder of the latest checkpoint
    under ``checkpointing.load`` if there is one, else initializes it from
    ``cfg.seed``.  ``lpips``: an ``LPIPS`` module on ``device``
    (``training/lpips.py::make_lpips``), or None for no LPIPS score.

    Spans (``utils/profiling.py``; nothing without an active recorder):
    ``run_test.setup``; per scene ``scene`` (the scene's name its unit)
    with ``scene.upload``, ``encode`` (the chunked encode's phases, or the
    encoder's spans), ``decode`` (a ``render`` a view), ``scene.metrics``,
    ``scene.readback`` (the host copies), ``scene.dumps`` (the scene's
    PNGs handed to the writer threads, after a ``dumps.wait`` for the
    previous scene's), ``scene.ply`` and ``scene.video``; then
    ``run_test.stats`` (first a ``dumps.wait`` for the last scene's
    files).  Each read or copy that waits for the device is counted in
    ``host_syncs``.  The PNGs are encoded on writer threads
    (``_PngWriter``; Pillow's PNG encoder and numpy's large ufuncs release
    the GIL) while the loop goes on with the next scene: at most two
    scenes' arrays are on the host, every file is on disk before
    ``stats.json`` is written, a writer's error is raised from here, and
    no writer thread outlives the call.  Counted under the scene that
    wrote them, when they are joined: ``png_files``, ``png_bytes`` and
    ``png_ms`` (a writer's host time, attribute ``kind``: color / gt /
    context / depth) a file, and ``png_hidden`` (the files already
    written when the loop came to wait for them).
    ``timings``, if given, collects per scene "encoder_s",
    "decoder_s_per_view", "metrics_s" and "dumps_s" (host clock around
    synchronized device work: the spans ``encode``, ``decode``,
    ``scene.metrics``, ``scene.readback`` to ``scene.dumps``: the dump
    time the loop still pays, readback, hand-off and wait), "ply_s"
    with ``test.save_ply``, "video_s" with ``test.save_video``, and with
    ``test.encode_view_chunk`` the chunked encode's phases
    (``make_chunked_encode``).  Without it nothing synchronizes but the
    reads; ``benchmark.json``'s encoder and decoder times are CUDA event
    pairs read after the scene's dropped-instance count.

    ``test.view_shard`` under a multi-process launch (world size > 1):
    every rank runs this loop, each scene's encode split over the ranks
    when they divide its context views (else, with a note, the unsharded
    encode), and only rank 0 writes files."""
    device = resolve_device(device)
    with span("run_test.setup"):
        group = None
        if cfg.test.view_shard and maybe_initialize_distributed(device):
            device = rank_device(device)
            group = make_group("auto")
        rank, world = group_rank(group)
        if max_scenes is None:
            max_scenes = cfg.test.max_scenes
            if max_scenes is None and cfg.dataset.name == "synthetic":
                max_scenes = 4  # the synthetic stream is infinite
        out_dir = Path(cfg.test.output_path)
        benchmarker = Benchmarker()
        if batches is None:
            from ..main import make_batches  # the CLI's dataset routing

            batches = make_batches(cfg, "test", device=device, replicated=world > 1)
        if state is None and cfg.checkpointing.load is not None:
            step = latest_step(cfg.checkpointing.load)
            if step is not None:
                state = load_checkpoint(cfg.checkpointing.load, step)["encoder"]

        encoder = make_encoder(
            dataclasses.replace(cfg.encoder, train_bn=cfg.test.bn_batch_stats),
            device=device, seed=cfg.seed,
        )
        if state is not None:
            if "params" in state:
                load_flax_variables(encoder, state)
            else:
                encoder.load_state_dict(state, strict=True)
        encode = encoder
        if cfg.test.encode_view_chunk:
            encode = make_chunked_encode(encoder, cfg.test.encode_view_chunk, timings)
        if world > 1:
            unsharded = encode
            sharded = make_chunked_encode(encoder, cfg.test.encode_view_chunk, timings, group=group)

            def encode(context):
                # Exact only when the views divide the ranks (padding with
                # duplicate views would change PTF's merges), as in JAX.
                v_ctx = context["image"].shape[1]
                if v_ctx % world == 0:
                    return sharded(context)
                print(f"[test] view_shard: {v_ctx} views not divisible by {world} devices — "
                      "unsharded encode for this scene", flush=True)
                return unsharded(context)
        decoder_cfg = cfg.decoder
        if cfg.test.render_capacity_factor is not None:
            decoder_cfg = dataclasses.replace(
                cfg.decoder, capacity_factor=cfg.test.render_capacity_factor
            )
        pngs = _PngWriter() if rank == 0 else None  # one writer under view_shard

    def on_device(views: dict, keys) -> dict:
        return {k: upload(views[k], device, "scene.upload") for k in keys if k in views}

    chunk = cfg.test.render_chunk_size

    def test_scene(batch) -> dict[str, Any]:
        """One scene: the spans of ``run_test``'s docstring; its stats entry."""
        scene = batch["scene"][0]
        with span("scene.upload"):
            context = on_device(batch["context"], _VIEW_KEYS)
            target = on_device(batch["target"], (*_VIEW_KEYS, "depth"))
        test_fvs = int(batch["target"].get("test_fvs", 0) or 0)
        h, w = target["image"].shape[2:4]
        v = target["image"].shape[1]

        with torch.no_grad():
            with span("encode"), benchmarker.time("encoder"):
                results = encode(context)
            colors, depths = [], []
            with span("decode", views=v), benchmarker.time("decoder", num_calls=v):
                dropped = torch.zeros((), dtype=torch.int64, device=device)
                for s in range(0, v, chunk):
                    sl = slice(s, min(s + chunk, v))
                    out = render_views(
                        decoder_cfg, results["gaussians"],
                        target["extrinsics"][:, sl], target["intrinsics"][:, sl],
                        target["near"][:, sl], target["far"][:, sl], (h, w),
                    )
                    colors.append(out.color[0])
                    depths.append(out.depth[0])
                    dropped = dropped + out.dropped.sum()
            with span("scene.metrics"):
                color = torch.cat(colors)  # (v, h, w, 3)
                depth = torch.cat(depths)  # (v, h, w)
                gt = target["image"][0]
                dropped_instances = host_value(dropped, "scene.metrics")
                benchmarker.resolve()  # the encoder's and decoder's events are done
                entry: dict[str, Any] = {
                    "scene": scene,
                    "num_views": v,
                    "num_gaussians": float(host_value(results["num_gaussians"][0],
                                                      "scene.metrics")),
                    "gs_ratio": float(host_value(results["gs_ratio"][0], "scene.metrics")),
                    "dropped_instances": float(dropped_instances),
                }

                def metric_block(pred, truth, prefix=""):
                    entry[prefix + "psnr"] = float(host_value(
                        compute_psnr(truth, pred).mean(), "scene.metrics"))
                    entry[prefix + "ssim"] = float(host_value(
                        compute_ssim(truth, pred).mean(), "scene.metrics"))
                    if lpips is not None and pred.shape[0] < 100:
                        entry[prefix + "lpips"] = float(host_value(
                            lpips(pred, truth).mean(), "scene.metrics"))

                if test_fvs > 0:
                    # FVS: the LAST test_fvs targets are extrapolation
                    # (mw:427-443, targets[length-fvs_length:]).
                    metric_block(color[:-test_fvs], gt[:-test_fvs], "interpolation_")
                    metric_block(color[-test_fvs:], gt[-test_fvs:], "extrapolation_")
                else:
                    metric_block(color, gt)
                if cfg.test.eval_depth and "depth" in target:
                    for k, val in depth_metrics(target["depth"][0], depth).items():
                        entry[f"depth_{k}"] = float(host_value(val, "scene.metrics"))
        if dropped_instances:
            print(
                f"[test] WARNING {scene}: rasterizer dropped {dropped_instances} "
                "instances (capacity overflow) - metrics are degraded; raise "
                "decoder.capacity_factor",
                flush=True,
            )

        writer = pngs is not None
        with span("scene.readback"):
            if writer:
                color_np = host_array(color, "scene.readback")
                gt_np = host_array(gt, "scene.readback")
                context_np = host_array(context["image"][0], "scene.readback")
                # Depth colormap dumps (reference mw:381-416): the encoder's
                # context depths and the rendered target depths.
                depth_np = {sub: host_array(maps, "scene.readback")
                            for sub, maps in (("depth_pred", results["depth_s-1"][0]),
                                              ("depth_render", depth))
                            } if cfg.test.save_depth else {}
        with span("scene.dumps"):
            if writer:
                # Frame dumps (FVS split into interpolation/extrapolation dirs).
                files = []
                for vi in range(v):
                    sub = ("extrapolation" if vi >= v - test_fvs else "interpolation"
                           ) if test_fvs > 0 else "color"
                    files.append(("color", color_np[vi], out_dir / scene / sub / f"{vi:04}.png"))
                    files.append(("gt", gt_np[vi], out_dir / scene / sub / f"{vi:04}_gt.png"))
                files += [("context", image, out_dir / scene / "context" / f"{vi:04}.png")
                          for vi, image in enumerate(context_np)]
                files += [("depth", depth_to_color(d), out_dir / scene / sub / f"{vi:04}.png")
                          for sub, maps in depth_np.items() for vi, d in enumerate(maps)]
                pngs.submit(scene, files)

        # Gaussian point-cloud export (reference encoder visualizer /
        # export pathway; covariances already decomposed by the adapter).
        if cfg.test.save_ply and writer:
            with span("scene.ply"):
                g = results["gaussians"]
                viz = results["visualizations"]
                export_ply(
                    *(host_array(x[0], "scene.ply") for x in (
                        g.means, viz["scales"], viz["rotations"], g.harmonics, g.opacities)),
                    out_dir / scene / "gaussians.ply",
                    mask=host_array(g.mask[0], "scene.ply"),
                )

        # Trajectory videos (reference mw:654-819).
        if cfg.test.save_video and writer:
            with span("scene.video"):
                vid_args = (
                    decoder_cfg, results["gaussians"], context["extrinsics"][0],
                    context["intrinsics"][0],
                    float(host_value(context["near"][0, 0], "scene.video")),
                    float(host_value(context["far"][0, 0], "scene.video")), (h, w),
                )
                render_video_wobble(*vid_args, out_dir / scene / "wobble.mp4")
                render_video_interpolation(*vid_args, out_dir / scene / "interpolation.mp4")
        return entry

    try:
        per_scene: list[dict[str, Any]] = []
        for scene_i, batch in enumerate(batches):
            if max_scenes is not None and scene_i >= max_scenes:
                break
            with timed(timings, _SCENE_TIMINGS), span("scene", unit=batch["scene"][0]):
                entry = test_scene(batch)
            per_scene.append(entry)
            print(f"[test] {entry['scene']}: " + " ".join(
                f"{k}={val:.4g}" for k, val in entry.items() if k != "scene"
            ), flush=True)

        with span("run_test.stats"):
            if pngs is not None:
                pngs.wait()  # every file on disk before the stats
            # Weighted per-scene averages (weights = view counts; mw:479-504) of
            # every key any scene has, each over the scenes that have it (the JAX
            # harness takes the first scene's keys only, so a run that mixes FVS
            # and plain scenes loses the keys its first scene lacks).
            summary: dict[str, float] = {}
            if per_scene:
                weights = np.asarray([e["num_views"] for e in per_scene], np.float64)
                for key in dict.fromkeys(k for e in per_scene for k in e):
                    if key in ("scene", "num_views"):
                        continue
                    vals = np.asarray([e.get(key, np.nan) for e in per_scene])
                    ok = np.isfinite(vals)
                    if ok.any():
                        summary[key] = float(np.sum(vals[ok] * weights[ok]) / np.sum(weights[ok]))
            if rank == 0:
                benchmarker.dump(out_dir / "benchmark.json")
                benchmarker.dump_memory(out_dir / "peak_memory.json")
                with open(out_dir / "stats.json", "w") as f:
                    json.dump({"per_scene": per_scene, "summary": summary}, f, indent=2)
    finally:
        if pngs is not None:
            pngs.close()
    print("[test] summary:", json.dumps(summary, indent=2), flush=True)
    return summary
