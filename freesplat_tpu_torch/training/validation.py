"""Validation: render one scene, log PSNR and a comparison grid.

Port of ``freesplat_tpu/training/validation.py::validation_step``
(reference ``ModelWrapper.validation_step``, ``model_wrapper.py:507-652``):
renders the target views of one validation scene, writes the context |
ground truth | prediction grid ``val_<step>.png`` and appends a line to
``val_metrics.txt``; with ``save_video`` also the wobble and
context-interpolation videos ``val_<step>_{wobble,interpolation}.gif``;
with ``save_projections`` the encoder panels
``val_<step>_{depth,gaussians,epipolar}.png``
(``utils/encoder_visualizer.py``), three orthographic projections of
scene 0's Gaussians ``val_<step>_projections.png``
(``models/render_extras.py``, through the forward kernel on the card) and
the camera frusta ``val_<step>_cameras.png`` (``utils/camera_viz.py``).

BN regime.  The JAX package validates with a fresh ``train_bn=True``
module (batch statistics) and throws the mutated ``batch_stats`` away.  A
port module in ``train()`` mode would update its running buffers, so the
forward runs under ``eval()`` and ``no_grad`` on an encoder that shares
the training weights and normalizes with batch statistics: the training
encoder itself when it was built with ``train_bn=True``, else a copy built
so.  The training encoder's buffers and mode are left as they were.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..evaluation.video import render_video_interpolation, render_video_wobble
from ..models.decoder import DecoderCfg, render_views
from ..models.encoder import EncoderFreeSplat, EncoderFreeSplatCfg
from ..models.render_extras import render_projections
from ..models.types import Gaussians
from ..training.metrics import compute_psnr
from ..utils.camera_viz import render_cameras
from ..utils.encoder_visualizer import (
    visualize_depth,
    visualize_epipolar_samples,
    visualize_gaussians,
)
from ..utils.visualization import add_label, hcat, vcat

_VIEW_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


def _batch_stats_encoder(cfg: EncoderFreeSplatCfg, encoder: EncoderFreeSplat) -> EncoderFreeSplat:
    if cfg.train_bn:
        return encoder
    twin = EncoderFreeSplat(dataclasses.replace(cfg, train_bn=True))
    twin.load_state_dict(encoder.state_dict(), strict=True)
    return twin.to(next(encoder.parameters()).device)


def validation_step(
    encoder_cfg: EncoderFreeSplatCfg,
    decoder_cfg: DecoderCfg,
    encoder: EncoderFreeSplat,
    batch: Mapping[str, Any],
    step: int,
    output_dir: str | Path = "outputs/local",
    save_video: bool = False,
    save_projections: bool = False,
) -> dict[str, float]:
    """Validate the training ``encoder`` (built from ``encoder_cfg``) on
    ``batch`` (numpy arrays or tensors, batch 1); returns {"psnr": dB}."""
    device = next(encoder.parameters()).device
    context = {k: torch.as_tensor(batch["context"][k]).to(device, torch.float32)
               for k in _VIEW_KEYS}
    target = {k: torch.as_tensor(batch["target"][k]).to(device, torch.float32)
              for k in _VIEW_KEYS}
    h, w = target["image"].shape[2:4]

    model = _batch_stats_encoder(encoder_cfg, encoder)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            results = model(context)
            out = render_views(
                decoder_cfg, results["gaussians"], target["extrinsics"],
                target["intrinsics"], target["near"], target["far"], (h, w),
            )
            psnr = float(compute_psnr(target["image"][0], out.color[0]).mean())
    finally:
        model.train(was_training)

    pred = out.color[0].cpu().numpy()
    gt = target["image"][0].cpu().numpy()
    ctx_row = hcat(*list(context["image"][0].cpu().numpy()))
    grid = vcat(
        add_label(ctx_row, "Context"),
        add_label(hcat(*list(gt)), "Target (Ground Truth)"),
        add_label(hcat(*list(pred)), "Target (Prediction)"),
    )

    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    from PIL import Image

    def save(image: np.ndarray, suffix: str = "") -> None:
        Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8)).save(
            out_dir / f"val_{step:0>7}{suffix}.png"
        )

    save(grid)
    with (out_dir / "val_metrics.txt").open("a") as f:
        scene = batch.get("scene", ["?"])[0]
        f.write(f"step {step} scene {scene} psnr {psnr:.4f}\n")

    if save_projections:
        # Encoder panels (reference encoder_visualizer_epipolar.py:177-275):
        # depth/disparity, the Gaussians' opacity/color/covariance, and
        # epipolar samples.
        g = results["gaussians"]
        save(visualize_depth(context, results["depth_s-1"]), "_depth")
        save(visualize_gaussians(context["image"], g.opacities, g.covariances,
                                 g.harmonics[..., 0] * 0.28209479177387814 + 0.5), "_gaussians")
        save(visualize_epipolar_samples(context, seed=step), "_epipolar")
        # 3D validation views: axis-aligned orthographic projections of the
        # predicted Gaussians (reference validation_in_3d.py via
        # model_wrapper.py:591-607).
        g0 = Gaussians(*(None if x is None else x[0] for x in g))
        with torch.no_grad():
            projections = render_projections(g0, resolution=256).cpu().numpy()
        save(hcat(*[add_label(projections[i], f"{'XYZ'[(i + 1) % 3]}{'XYZ'[(i + 2) % 3]} "
                              "Projection") for i in range(3)]), "_projections")
        # Camera frusta (reference render_cameras, validation_in_3d.py:
        # 92-121: context white, targets red).
        save(hcat(*list(render_cameras(batch, resolution=256))), "_cameras")

    if save_video:
        # Trajectory videos, as the reference logs during validation
        # (model_wrapper.py:654-819: wobble + context interpolation).
        vid_args = (
            decoder_cfg, results["gaussians"], context["extrinsics"][0],
            context["intrinsics"][0], float(context["near"][0, 0]),
            float(context["far"][0, 0]), (h, w),
        )
        render_video_wobble(*vid_args, out_dir / f"val_{step:0>7}_wobble.mp4")
        render_video_interpolation(*vid_args, out_dir / f"val_{step:0>7}_interpolation.mp4")
    return {"psnr": psnr}
