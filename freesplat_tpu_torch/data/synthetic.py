"""Synthetic scene generator: random Gaussian-splat rooms rendered from a
short camera chain.  Used for tests, benchmarks and training when no real
dataset is mounted.

Port of ``freesplat_tpu/data/synthetic.py``: the same numpy draws in the
same order (so a seed gives the same scenes, cameras and context/target
split), rendered by the port's rasterizers, and the batch's arrays as
tensors on the requested device.  Scenes are consistent across views (one
Gaussian cloud seen from every camera), so multi-view depth and PTF have
real signal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..ops.gaussians import build_covariance
from ..ops.rasterizer import rasterize
from ..ops.rasterizer_ref import render_reference
from ..utils.device import resolve_device


@dataclass(frozen=True)
class SyntheticCfg:
    num_gaussians: int = 4000
    image_shape: tuple[int, int] = (64, 64)
    num_context: int = 2
    num_target: int = 2
    near: float = 0.5
    far: float = 15.0
    seed: int = 0
    # > 0: render this many camera chains once and cycle through them.
    cache_batches: int = 0
    # Fresh Gaussian cloud per batch, seeded by (seed, scene_id); the
    # default keeps one cloud and draws fresh cameras per batch.
    vary_scene: bool = False
    # "reference": the dense golden compositor (exact; O(n * pixels)
    # memory, for small shapes).  "tile": the tile rasterizer with a
    # generous capacity (on the GPU, the ``rasterize_fwd`` kernel).
    renderer: str = "reference"


def _random_scene(rng: np.random.Generator, n: int, device: torch.device):
    means = rng.uniform([-3, -3, 1.5], [3, 3, 9.0], size=(n, 3))
    scales = rng.uniform(0.05, 0.25, size=(n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    harm = rng.normal(size=(n, 3, 1)) * 0.8
    opac = rng.uniform(0.5, 1.0, size=n)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return t(means), build_covariance(t(scales), t(quats)), t(harm), t(opac)


def _camera_ring(rng: np.random.Generator, num: int):
    """Small-baseline forward-facing camera chain (ScanNet-like motion)."""
    extr = []
    base = np.eye(4, dtype=np.float32)
    for i in range(num):
        e = base.copy()
        e[0, 3] = 0.25 * i + rng.normal() * 0.02
        e[1, 3] = rng.normal() * 0.02
        theta = 0.05 * i
        c, s = np.cos(theta), np.sin(theta)
        e[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        extr.append(e)
    return np.stack(extr)


def synthetic_batches(cfg: SyntheticCfg, device: str | torch.device = "cuda") -> Iterator[dict]:
    """Infinite iterator of single-scene batches (b=1) of tensors on
    ``device`` (default the GPU; raises here, before the first batch,
    without one)."""
    return _stream(cfg, resolve_device(device))


@torch.no_grad()
def _render_all(cfg: SyntheticCfg, extrs: torch.Tensor, intr: torch.Tensor, scene):
    """(colors (v, h, w, 3) clipped to [0, 1], alpha-normalized depths (v, h, w))."""
    means, cov, harm, opac = scene
    bg = torch.zeros(3, device=means.device)
    colors, depths = [], []
    for e in extrs:
        if cfg.renderer == "tile":
            color, depth, alpha = rasterize(
                means, cov, harm, opac, e, intr, cfg.image_shape, bg, 0,
                capacity=max(16 * cfg.num_gaussians, 65536),
            )
        else:
            color, depth, alpha = render_reference(
                means, cov, harm, opac, e, intr, cfg.image_shape, bg, 0
            )
        colors.append(torch.clamp(color, 0.0, 1.0))
        depths.append(depth / torch.clamp(alpha, min=1e-6))
    return torch.stack(colors), torch.stack(depths)


def _stream(cfg: SyntheticCfg, device: torch.device) -> Iterator[dict]:
    rng = np.random.default_rng(cfg.seed)
    intr_np = np.array([[1.07, 0, 0.5], [0, 1.42, 0.5], [0, 0, 1]], dtype=np.float32)
    intr = torch.from_numpy(intr_np).to(device)
    scene0 = _random_scene(rng, cfg.num_gaussians, device)

    def make_batch(scene_id: int) -> dict:
        if cfg.vary_scene:
            scene = _random_scene(
                np.random.default_rng([cfg.seed, scene_id]), cfg.num_gaussians, device
            )
        else:
            scene = scene0
        v_total = cfg.num_context + cfg.num_target
        extr = torch.from_numpy(_camera_ring(rng, v_total)).to(device)
        colors, depths = _render_all(cfg, extr, intr, scene)
        # Contexts evenly spaced over the trajectory (endpoints included),
        # targets the remaining interior views: the bounded sampler's
        # interpolation protocol.
        order = np.arange(v_total)
        ctx = np.unique(np.round(np.linspace(0, v_total - 1, cfg.num_context)).astype(int))
        tgt = np.setdiff1d(order, ctx)[: cfg.num_target]

        def views(sel):
            i = torch.from_numpy(sel).to(device)
            n = len(sel)
            return {
                "extrinsics": extr[i][None],
                "intrinsics": intr.expand(n, 3, 3).clone()[None],
                "image": colors[i][None],
                "near": torch.full((1, n), cfg.near, device=device),
                "far": torch.full((1, n), cfg.far, device=device),
                "index": i[None],
                "depth": depths[i][None],
            }

        return {"context": views(ctx), "target": views(tgt), "scene": [f"synthetic_{scene_id}"]}

    if cfg.cache_batches > 0:
        cached = [make_batch(i) for i in range(cfg.cache_batches)]
        i = 0
        while True:
            yield cached[i % len(cached)]
            i += 1
    else:
        scene_id = 0
        while True:
            yield make_batch(scene_id)
            scene_id += 1
