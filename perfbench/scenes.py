"""The general traffic generator: a pool of host-side scenes from a mix's
parameters and the run's seed.

A scene is a cloud of ``gaussians_per_scene`` random Gaussian splats seen
from a camera path.  Frames are rendered by the benchmark's own plain
compositor (``reference/render.py``); the pool is returned as numpy
arrays, as a data loader hands batches over, so the program's copy to the
device stays inside the window.

The cloud (``layout``):

- ``"volume"`` (the default): the same numpy draws, in the same order, as
  ``freesplat_tpu_torch/data/synthetic.py``: splats uniform in the box
  [``cloud_min``, ``cloud_max``], pushed out of a column of
  ``clear_radius_m`` round the y axis, each of a random colour;
- ``"room"``: splats on the box's six faces (walls, floor and ceiling, a
  face's share by its area), coloured as painted surfaces: a base colour
  per face, a smooth variation over it (``color_wave_m``, the wavelength)
  and a little per-splat texture (``color_noise``), so frames are mostly
  smooth regions and edges, as camera frames of a room are.

The path (``path``):

- ``"chain"`` (the default): as ``data/synthetic.py``'s, the camera slides
  sideways ``step_m`` a frame and turns ``yaw_rad``; the contexts are
  spaced evenly along ``context_views + target_views`` frames, endpoints
  included, and the targets are the remaining interior frames;
- ``"walk"``: the camera walks forward ``step_m`` a frame while turning
  ``yaw_rad`` (a loop round the room's centre), and the frames are an
  evaluation index's: ``context_views`` contexts every ``context_stride``
  frames from frame 0, and ``target_views`` targets spread evenly over
  frames 0 to ``target_last_frame``, endpoints included.

Both paths jitter each frame's position by 2 cm.  Other mix parameters
read here: ``context_views``, ``target_views``, ``pool_scenes``; the
configuration gives the image shape and near/far.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.model import build_covariance
from .reference.render import render_input

INTRINSICS = np.array([[1.07, 0, 0.5], [0, 1.42, 0.5], [0, 0, 1]], dtype=np.float32)


def _cloud(rng: np.random.Generator, n: int, lo, hi, clear: float):
    means = rng.uniform(lo, hi, size=(n, 3))
    if clear > 0:  # keep the splats off the camera path: out of a column round the y axis
        r = np.linalg.norm(means[:, [0, 2]], axis=-1, keepdims=True)
        means[:, [0, 2]] *= np.maximum(clear / np.maximum(r, 1e-6), 1.0)
    scales = rng.uniform(0.05, 0.25, size=(n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    harm = rng.normal(size=(n, 3, 1)) * 0.8
    opac = rng.uniform(0.5, 1.0, size=n)
    return means, scales, quats, harm, opac


def _room(rng: np.random.Generator, n: int, lo, hi, wave_m: float, noise: float):
    """Splats on the six faces of the box [lo, hi], painted: each face a base
    colour, a smooth variation of period ``wave_m`` and per-splat texture."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    size = hi - lo
    faces = [(axis, side) for axis in range(3) for side in (0, 1)]
    area = np.array([np.prod(np.delete(size, axis)) for axis, _ in faces])
    face = rng.choice(len(faces), size=n, p=area / area.sum())
    means = rng.uniform(lo, hi, size=(n, 3))
    for f, (axis, side) in enumerate(faces):
        means[face == f, axis] = hi[axis] if side else lo[axis]
    scales = rng.uniform(0.05, 0.25, size=(n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    base = rng.uniform(-1.2, 1.2, size=(len(faces), 3))
    phase = rng.uniform(0, 2 * np.pi, size=(len(faces), 3, 3))
    k = 2 * np.pi / wave_m
    smooth = 0.5 * np.sin(k * means[:, None, :] + phase[face]).mean(-1)  # (n, 3 colours)
    harm = (base[face] + smooth + rng.normal(size=(n, 3)) * noise)[..., None]
    opac = rng.uniform(0.5, 1.0, size=n)
    return means, scales, quats, harm, opac


def _chain(rng: np.random.Generator, num: int, step_m: float, yaw_rad: float) -> np.ndarray:
    extr = []
    for i in range(num):
        e = np.eye(4, dtype=np.float32)
        e[0, 3] = step_m * i + rng.normal() * 0.02
        e[1, 3] = rng.normal() * 0.02
        c, s = np.cos(yaw_rad * i), np.sin(yaw_rad * i)
        e[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        extr.append(e)
    return np.stack(extr)


def _walk(rng: np.random.Generator, frames: int, step_m: float, yaw_rad: float) -> np.ndarray:
    """Forward ``step_m`` and a turn of ``yaw_rad`` a frame: a circle of
    radius ``step_m / yaw_rad`` round the origin, the camera looking along
    its way."""
    radius = step_m / yaw_rad
    extr = []
    for i in range(frames):
        e = np.eye(4, dtype=np.float32)
        t = yaw_rad * i
        c, s = np.cos(t), np.sin(t)
        e[:3, 3] = [-radius * c + rng.normal() * 0.02, rng.normal() * 0.02, radius * s]
        e[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        extr.append(e)
    return np.stack(extr)


def frames_of(traffic: dict) -> tuple[np.ndarray, np.ndarray, int]:
    """(context frames, target frames, frames on the path) of a mix."""
    n_ctx, n_tgt = traffic["context_views"], traffic["target_views"]
    if traffic.get("path", "chain") == "walk":
        ctx = np.arange(n_ctx) * traffic["context_stride"]
        tgt = np.round(np.linspace(0, traffic["target_last_frame"], n_tgt)).astype(int)
        return ctx, tgt, int(max(ctx.max(), tgt.max())) + 1
    total = n_ctx + n_tgt
    ctx = np.unique(np.round(np.linspace(0, total - 1, n_ctx)).astype(int))
    return ctx, np.setdiff1d(np.arange(total), ctx)[:n_tgt], total


@torch.no_grad()
def make_pool(traffic: dict, overrides: dict, seed: int, device) -> list[dict]:
    """``pool_scenes`` batches (batch 1, numpy) drawn from ``seed``."""
    h, w = overrides["dataset.image_shape"]
    near, far = float(overrides["encoder.near"]), float(overrides["encoder.far"])
    ctx, tgt, frames = frames_of(traffic)
    shown = np.union1d(ctx, tgt)  # the frames rendered
    intr = torch.from_numpy(INTRINSICS).to(device)
    pool = []
    for scene_id in range(traffic["pool_scenes"]):
        rng = np.random.default_rng([seed % (1 << 63), scene_id])
        n, lo, hi = traffic["gaussians_per_scene"], traffic["cloud_min"], traffic["cloud_max"]
        cloud = (_room(rng, n, lo, hi, traffic["color_wave_m"], traffic["color_noise"])
                 if traffic.get("layout", "volume") == "room"
                 else _cloud(rng, n, lo, hi, traffic["clear_radius_m"]))
        means, scales, quats, harm, opac = (
            torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in cloud)
        covs = build_covariance(scales, quats)
        extr = (_walk if traffic.get("path", "chain") == "walk" else _chain)(
            rng, frames, traffic["step_m"], traffic["yaw_rad"])
        rendered = [render_input(means, covs, harm, opac, torch.from_numpy(extr[f]).to(device),
                                 intr, (h, w)) for f in shown]
        colors = torch.stack([f[0] for f in rendered]).cpu().numpy()
        depths = torch.stack([f[1] for f in rendered]).cpu().numpy()

        def views(sel):
            n, at = len(sel), np.searchsorted(shown, sel)
            return {
                "image": colors[at][None],
                "extrinsics": extr[sel][None],
                "intrinsics": np.broadcast_to(INTRINSICS, (n, 3, 3)).copy()[None],
                "near": np.full((1, n), near, np.float32),
                "far": np.full((1, n), far, np.float32),
                "depth": depths[at][None],
            }

        pool.append({"context": views(ctx), "target": views(tgt),
                     "scene": [f"pool{scene_id}"]})
    return pool


def to_device(views: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device, torch.float32) for k, v in views.items()}
