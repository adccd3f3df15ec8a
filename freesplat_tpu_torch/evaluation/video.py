"""Trajectory videos (reference ``model_wrapper.py:654-819``: the wobble
and context-interpolation videos of validation and test).

Port of ``freesplat_tpu/evaluation/video.py``.  Frames are rendered
through ``models/decoder.py::render_views`` (the forward kernel on the
GPU), 10 views a call, and written as a GIF by ``utils/visualization.py::
save_video`` (a ``.mp4`` name becomes ``.gif``).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.decoder import DecoderCfg, render_views
from ..models.types import Gaussians
from ..utils.camera_trajectory import (
    generate_wobble,
    interpolate_extrinsics,
    interpolate_intrinsics,
)
from ..utils.visualization import save_video


@torch.no_grad()
def render_trajectory(
    decoder_cfg: DecoderCfg,
    gaussians: Gaussians,  # batched (1, g, ...)
    extrinsics: torch.Tensor,  # (t, 4, 4)
    intrinsics: torch.Tensor,  # (t, 3, 3)
    near: float,
    far: float,
    image_shape: tuple[int, int],
    chunk: int = 10,
) -> np.ndarray:
    """Render a camera path -> (t, h, w, 3) float32 frames on the host."""
    t = extrinsics.shape[0]
    frames = []
    for s in range(0, t, chunk):
        sl = slice(s, min(s + chunk, t))
        nv = extrinsics[sl].shape[0]
        bounds = [torch.full((1, nv), x, dtype=torch.float32, device=extrinsics.device)
                  for x in (near, far)]
        out = render_views(
            decoder_cfg, gaussians, extrinsics[None, sl], intrinsics[None, sl],
            *bounds, image_shape,
        )
        frames.append(out.color[0].cpu().numpy())
    return np.concatenate(frames)


def render_video_wobble(
    decoder_cfg: DecoderCfg,
    gaussians: Gaussians,
    context_extrinsics: torch.Tensor,  # (v, 4, 4)
    context_intrinsics: torch.Tensor,  # (v, 3, 3)
    near: float,
    far: float,
    image_shape: tuple[int, int],
    path: str | Path,
    num_frames: int = 30,
) -> np.ndarray:
    """Circular wobble around the first context pose (mw:666-703)."""
    delta = torch.linalg.vector_norm(
        context_extrinsics[0, :3, 3] - context_extrinsics[-1, :3, 3]) + 1e-3
    t = torch.linspace(0.0, 1.0, num_frames, device=context_extrinsics.device)
    extr = generate_wobble(context_extrinsics[0], delta * 0.25, t)
    intr = context_intrinsics[0][None].expand(num_frames, 3, 3)
    frames = render_trajectory(decoder_cfg, gaussians, extr, intr, near, far, image_shape)
    save_video(list(frames), path)
    return frames


def render_video_interpolation(
    decoder_cfg: DecoderCfg,
    gaussians: Gaussians,
    context_extrinsics: torch.Tensor,  # (v, 4, 4)
    context_intrinsics: torch.Tensor,
    near: float,
    far: float,
    image_shape: tuple[int, int],
    path: str | Path,
    num_frames: int = 30,
) -> np.ndarray:
    """Smooth path from the first to the last context view (mw:705-747)."""
    t = torch.from_numpy(np.linspace(0.0, 1.0, num_frames))  # float64, as JAX's numpy t
    extr = interpolate_extrinsics(context_extrinsics[0], context_extrinsics[-1], t)
    intr = interpolate_intrinsics(context_intrinsics[0], context_intrinsics[-1],
                                  t.to(context_intrinsics))
    frames = render_trajectory(decoder_cfg, gaussians, extr, intr, near, far, image_shape)
    save_video(list(frames), path)
    return frames
