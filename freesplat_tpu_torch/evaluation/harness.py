"""Test harness (reference ``ModelWrapper.test_step`` + ``on_test_end``,
``src/model/model_wrapper.py:305-504``).

Port of ``freesplat_tpu/evaluation/harness.py::run_test``.  Per scene:
timed encoder forward -> chunked rendering of the target views -> PSNR,
SSIM (+ LPIPS under 100 frames), split into interpolation and
extrapolation blocks on FVS scenes -> rendered-depth metrics against the
sensor depth -> frame and depth-colormap dumps; then the view-weighted
per-scene averages and ``benchmark.json``, ``peak_memory.json`` (the
port's own format, ``utils/benchmarker.py``) and ``stats.json`` under
``test.output_path``.  Without ``batches`` it reads the configured
dataset (``main.make_batches``).  Not ported yet: PLY and video export,
``view_shard`` and ``encode_view_chunk``; a cfg that asks for one raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch
from PIL import Image

from ..config.config import RootCfg
from ..models.decoder import render_views
from ..models.encoder import make_encoder
from ..training.checkpoint import latest_step, load_checkpoint
from ..training.metrics import compute_psnr, compute_ssim, depth_metrics
from ..utils.benchmarker import Benchmarker
from ..utils.device import resolve_device
from ..utils.flax_bridge import load_flax_variables
from ..utils.visualization import depth_to_color

_VIEW_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


def _unsupported(cfg: RootCfg) -> list[str]:
    t = cfg.test
    asked = {
        "test.save_ply": t.save_ply,
        "test.save_video": t.save_video,
        "test.view_shard": t.view_shard,
        "test.encode_view_chunk": t.encode_view_chunk,
    }
    return [k for k, v in asked.items() if v]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _save_image(array: np.ndarray, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((np.clip(np.asarray(array), 0, 1) * 255).astype(np.uint8)).save(path)


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
    ``timings``, if given, collects per scene "encoder_s",
    "decoder_s_per_view", "metrics_s" and "dumps_s" (host clock around
    synchronized device work)."""
    device = resolve_device(device)
    unsupported = _unsupported(cfg)
    if unsupported:
        raise NotImplementedError(f"run_test: not ported yet: {unsupported}")
    if max_scenes is None:
        max_scenes = cfg.test.max_scenes
        if max_scenes is None and cfg.dataset.name == "synthetic":
            max_scenes = 4  # the synthetic stream is infinite
    out_dir = Path(cfg.test.output_path)
    benchmarker = Benchmarker()
    if batches is None:
        from ..main import make_batches  # the CLI's dataset routing

        batches = make_batches(cfg, "test", device=device)
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
    decoder_cfg = cfg.decoder
    if cfg.test.render_capacity_factor is not None:
        decoder_cfg = dataclasses.replace(
            cfg.decoder, capacity_factor=cfg.test.render_capacity_factor
        )

    def on_device(views: dict, keys) -> dict:
        return {k: torch.as_tensor(views[k]).to(device, torch.float32)
                for k in keys if k in views}

    def record(key, seconds):
        if timings is not None:
            timings.setdefault(key, []).append(seconds)

    per_scene: list[dict[str, Any]] = []
    chunk = cfg.test.render_chunk_size
    for scene_i, batch in enumerate(batches):
        if max_scenes is not None and scene_i >= max_scenes:
            break
        scene = batch["scene"][0]
        context = on_device(batch["context"], _VIEW_KEYS)
        target = on_device(batch["target"], (*_VIEW_KEYS, "depth"))
        test_fvs = int(batch["target"].get("test_fvs", 0) or 0)
        h, w = target["image"].shape[2:4]
        v = target["image"].shape[1]

        with torch.no_grad():
            _sync(device)
            t0 = time.perf_counter()
            with benchmarker.time("encoder"):
                results = encoder(context)
            t1 = time.perf_counter()
            colors, depths = [], []
            dropped = torch.zeros((), dtype=torch.int64, device=device)
            with benchmarker.time("decoder", num_calls=v):
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
            t2 = time.perf_counter()
            color = torch.cat(colors)  # (v, h, w, 3)
            depth = torch.cat(depths)  # (v, h, w)
            gt = target["image"][0]
            dropped_instances = int(dropped)
            entry: dict[str, Any] = {
                "scene": scene,
                "num_views": v,
                "num_gaussians": float(results["num_gaussians"][0]),
                "gs_ratio": float(results["gs_ratio"][0]),
                "dropped_instances": float(dropped_instances),
            }

            def metric_block(pred, truth, prefix=""):
                entry[prefix + "psnr"] = float(compute_psnr(truth, pred).mean())
                entry[prefix + "ssim"] = float(compute_ssim(truth, pred).mean())
                if lpips is not None and pred.shape[0] < 100:
                    entry[prefix + "lpips"] = float(lpips(pred, truth).mean())

            if test_fvs > 0:
                # FVS: the LAST test_fvs targets are extrapolation
                # (mw:427-443, targets[length-fvs_length:]).
                metric_block(color[:-test_fvs], gt[:-test_fvs], "interpolation_")
                metric_block(color[-test_fvs:], gt[-test_fvs:], "extrapolation_")
            else:
                metric_block(color, gt)
            if cfg.test.eval_depth and "depth" in target:
                for k, val in depth_metrics(target["depth"][0], depth).items():
                    entry[f"depth_{k}"] = float(val)
            t3 = time.perf_counter()
        if dropped_instances:
            print(
                f"[test] WARNING {scene}: rasterizer dropped {dropped_instances} "
                "instances (capacity overflow) - metrics are degraded; raise "
                "decoder.capacity_factor",
                flush=True,
            )

        # Frame dumps (FVS split into interpolation/extrapolation dirs).
        color_np, gt_np = color.cpu().numpy(), gt.cpu().numpy()
        for vi in range(v):
            sub = ("extrapolation" if vi >= v - test_fvs else "interpolation"
                   ) if test_fvs > 0 else "color"
            _save_image(color_np[vi], out_dir / scene / sub / f"{vi:04}.png")
            _save_image(gt_np[vi], out_dir / scene / sub / f"{vi:04}_gt.png")
        for vi, image in enumerate(context["image"][0].cpu().numpy()):
            _save_image(image, out_dir / scene / "context" / f"{vi:04}.png")
        # Depth colormap dumps (reference mw:381-416): the encoder's
        # context depths and the rendered target depths.
        if cfg.test.save_depth:
            for vi, d in enumerate(results["depth_s-1"][0].cpu().numpy()):
                _save_image(depth_to_color(d), out_dir / scene / "depth_pred" / f"{vi:04}.png")
            for vi, d in enumerate(depth.cpu().numpy()):
                _save_image(depth_to_color(d), out_dir / scene / "depth_render" / f"{vi:04}.png")
        t4 = time.perf_counter()
        record("encoder_s", t1 - t0)
        record("decoder_s_per_view", (t2 - t1) / v)
        record("metrics_s", t3 - t2)
        record("dumps_s", t4 - t3)
        per_scene.append(entry)
        print(f"[test] {scene}: " + " ".join(
            f"{k}={val:.4g}" for k, val in entry.items() if k != "scene"
        ), flush=True)

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
    benchmarker.dump(out_dir / "benchmark.json")
    benchmarker.dump_memory(out_dir / "peak_memory.json")
    with open(out_dir / "stats.json", "w") as f:
        json.dump({"per_scene": per_scene, "summary": summary}, f, indent=2)
    print("[test] summary:", json.dumps(summary, indent=2), flush=True)
    return summary
