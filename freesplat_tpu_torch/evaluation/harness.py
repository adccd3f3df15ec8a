"""Test harness: per scene, encode the context views, render the target
views in chunks, warn on dropped rasterizer instances, score PSNR.

Port of the per-scene loop of ``freesplat_tpu/evaluation/harness.py::
run_test``.  Not ported yet: dataset loading (pass ``batches``), SSIM,
LPIPS, depth metrics, image/depth/PLY/video dumps, ``view_shard`` and
``encode_view_chunk``; a cfg that asks for one raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Iterable

import numpy as np
import torch

from ..config.config import RootCfg
from ..models.decoder import render_views
from ..models.encoder import make_encoder
from ..training.metrics import compute_psnr
from ..utils.device import resolve_device
from ..utils.flax_bridge import load_flax_variables

_VIEW_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


def _unsupported(cfg: RootCfg, lpips_params: Any) -> list[str]:
    t = cfg.test
    asked = {
        "test.save_depth": t.save_depth,
        "test.save_ply": t.save_ply,
        "test.save_video": t.save_video,
        "test.view_shard": t.view_shard,
        "test.encode_view_chunk": t.encode_view_chunk,
        "lpips_params": lpips_params is not None,
    }
    return [k for k, v in asked.items() if v]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_test(
    cfg: RootCfg,
    batches: Iterable[dict] | None = None,
    state: dict | None = None,
    max_scenes: int | None = None,
    lpips_params: Any = None,
    device: str | torch.device = "cuda",
    timings: dict[str, list[float]] | None = None,
) -> dict[str, float]:
    """Evaluate ``batches`` (dicts of numpy arrays or tensors with batch 1:
    ``scene``, ``context`` and ``target`` views) and return the view-weighted
    per-scene averages.

    ``state``: flax variables ({"params", "batch_stats"}, bridged) or the
    port's state_dict; None initializes the encoder from ``cfg.seed``.
    ``timings``, if given, collects per scene "encoder_s" and
    "decoder_s_per_view" (host clock around synchronized device work)."""
    device = resolve_device(device)
    unsupported = _unsupported(cfg, lpips_params)
    if unsupported:
        raise NotImplementedError(f"run_test: not ported yet: {unsupported}")
    if batches is None:
        raise NotImplementedError("run_test: dataset loading is not ported yet; pass batches")
    if max_scenes is None:
        max_scenes = cfg.test.max_scenes

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

    def on_device(views: dict) -> dict:
        return {k: torch.as_tensor(views[k]).to(device, torch.float32) for k in _VIEW_KEYS}

    per_scene: list[dict[str, Any]] = []
    chunk = cfg.test.render_chunk_size
    for scene_i, batch in enumerate(batches):
        if max_scenes is not None and scene_i >= max_scenes:
            break
        scene = batch["scene"][0]
        target_raw = batch["target"]
        if cfg.test.eval_depth and "depth" in target_raw:
            raise NotImplementedError("run_test: depth metrics are not ported yet")
        context = on_device(batch["context"])
        target = on_device(target_raw)
        h, w = target["image"].shape[2:4]
        v = target["image"].shape[1]

        with torch.no_grad():
            _sync(device)
            t0 = time.perf_counter()
            results = encoder(context)
            _sync(device)
            t1 = time.perf_counter()
            colors = []
            dropped_instances = 0
            for s in range(0, v, chunk):
                sl = slice(s, min(s + chunk, v))
                out = render_views(
                    decoder_cfg, results["gaussians"],
                    target["extrinsics"][:, sl], target["intrinsics"][:, sl],
                    target["near"][:, sl], target["far"][:, sl], (h, w),
                )
                colors.append(out.color[0])
                dropped_instances += int(out.dropped.sum())
            _sync(device)
            t2 = time.perf_counter()
        if timings is not None:
            timings.setdefault("encoder_s", []).append(t1 - t0)
            timings.setdefault("decoder_s_per_view", []).append((t2 - t1) / v)
        if dropped_instances:
            print(
                f"[test] WARNING {scene}: rasterizer dropped {dropped_instances} "
                "instances (capacity overflow) - metrics are degraded; raise "
                "decoder.capacity_factor",
                flush=True,
            )
        color = torch.cat(colors)  # (v, h, w, 3)
        entry: dict[str, Any] = {
            "scene": scene,
            "num_views": v,
            "num_gaussians": float(results["num_gaussians"][0]),
            "gs_ratio": float(results["gs_ratio"][0]),
            "dropped_instances": float(dropped_instances),
            "psnr": float(compute_psnr(target["image"][0], color).mean()),
        }
        per_scene.append(entry)
        print(f"[test] {scene}: " + " ".join(
            f"{k}={val:.4g}" for k, val in entry.items() if k != "scene"
        ), flush=True)

    summary: dict[str, float] = {}
    if per_scene:
        weights = np.asarray([e["num_views"] for e in per_scene], np.float64)
        for key in per_scene[0]:
            if key in ("scene", "num_views"):
                continue
            vals = np.asarray([e.get(key, np.nan) for e in per_scene])
            ok = np.isfinite(vals)
            if ok.any():
                summary[key] = float(np.sum(vals[ok] * weights[ok]) / np.sum(weights[ok]))
    print("[test] summary:", json.dumps(summary, indent=2), flush=True)
    return summary
