"""Cross-method metric computation over dumped frames.

Port of ``freesplat_tpu/evaluation/metric_computer.py`` (parity target
``src/evaluation/metric_computer.py:15-115``): given directories of
rendered frames from multiple methods plus ground truth, compute PSNR/SSIM
(and LPIPS with an LPIPS module) per method and tabulate.  Frame layout:
``<root>/<method>/<scene>/color/<idx>.png`` with ground truth dumped
alongside as ``<idx>_gt.png`` (the layout the test harness writes) or a
dedicated gt method directory.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
from PIL import Image

from ..training.metrics import compute_psnr, compute_ssim
from ..utils.device import resolve_device


@dataclass
class MethodCfg:
    name: str
    key: str  # directory name
    path: str


@dataclass
class MetricComputerCfg:
    methods: Sequence[MethodCfg] = ()
    output_path: str = "outputs/metrics"


def _load_frames(directory: Path, suffix: str = ".png", gt: bool = False):
    frames = {}
    for p in sorted(directory.glob(f"*{suffix}")):
        is_gt = p.stem.endswith("_gt")
        if is_gt != gt:
            continue
        key = p.stem.replace("_gt", "")
        frames[key] = np.asarray(Image.open(p)).astype(np.float32) / 255.0
    return frames


@torch.no_grad()
def compute_scene_metrics(
    method_dir: Path, lpips: torch.nn.Module | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, float] | None:
    """PSNR/SSIM (+LPIPS) for one method/scene directory of pred+gt dumps,
    computed on ``device`` (``lpips``: an ``LPIPS`` module there)."""
    device = resolve_device(device)
    color_dir = method_dir / "color"
    if not color_dir.is_dir():
        color_dir = method_dir
    preds = _load_frames(color_dir, gt=False)
    gts = _load_frames(color_dir, gt=True)
    keys = sorted(set(preds) & set(gts))
    if not keys:
        return None
    pred = torch.as_tensor(np.stack([preds[k] for k in keys]), device=device)
    gt = torch.as_tensor(np.stack([gts[k] for k in keys]), device=device)
    out = {
        "psnr": float(compute_psnr(gt, pred).mean()),
        "ssim": float(compute_ssim(gt, pred).mean()),
        "num_frames": len(keys),
    }
    if lpips is not None:
        out["lpips"] = float(lpips(pred, gt).mean())
    return out


def run_metric_computer(
    cfg: MetricComputerCfg, lpips: torch.nn.Module | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, dict[str, float]]:
    """Tabulate metrics across methods; dumps a JSON + prints a table."""
    table: dict[str, dict[str, float]] = {}
    for method in cfg.methods:
        root = Path(method.path) / method.key
        if not root.is_dir():
            root = Path(method.path)
        per_scene = []
        for scene_dir in sorted(p for p in root.iterdir() if p.is_dir()):
            m = compute_scene_metrics(scene_dir, lpips, device)
            if m is not None:
                per_scene.append(m)
        if not per_scene:
            continue
        weights = np.asarray([m["num_frames"] for m in per_scene], np.float64)
        agg = {}
        for key in per_scene[0]:
            if key == "num_frames":
                agg[key] = float(weights.sum())
                continue
            vals = np.asarray([m[key] for m in per_scene])
            agg[key] = float((vals * weights).sum() / weights.sum())
        table[method.name] = agg

    out_dir = Path(cfg.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    with (out_dir / "metrics.json").open("w") as f:
        json.dump(table, f, indent=2)

    if table:
        cols = [k for k in next(iter(table.values())) if k != "num_frames"]
        header = "method".ljust(24) + "".join(c.rjust(10) for c in cols)
        print(header)
        for name, agg in table.items():
            print(
                name.ljust(24)
                + "".join(f"{agg[c]:10.4f}" for c in cols)
            )
    return table
