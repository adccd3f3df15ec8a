"""Training losses: MSE + LPIPS + the auxiliary depth losses.

Port of ``freesplat_tpu/training/losses.py``: each loss is a function of
(prediction, target, step) plus the LPIPS module, and ``total_loss``
composes them per config into the same ``parts`` dict.  The depth terms
(``training/depth_losses.py``) supervise the rendered target depth with
the sensor depth, and the encoder's context depths with each other; every
preset leaves their weights at 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config.config import LossCfg, LossDepthCfg, LossLpipsCfg, LossMseCfg
from .depth_losses import (
    depth_to_normals,
    ms_gradient_loss,
    mv_depth_loss,
    normals_loss,
    scale_invariant_loss,
)

__all__ = [
    "LossCfg", "LossDepthCfg", "LossLpipsCfg", "LossMseCfg",
    "depth_supervision", "lpips_loss", "mse_loss", "total_loss",
]


def mse_loss(cfg: LossMseCfg, pred_color: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return cfg.weight * ((pred_color - target) ** 2).mean()


def lpips_loss(
    cfg: LossLpipsCfg,
    lpips: torch.nn.Module,
    pred_color: torch.Tensor,  # (b, v, h, w, 3)
    target: torch.Tensor,
    global_step: int,
) -> torch.Tensor:
    """Weighted mean LPIPS over every (batch, view) image; 0 before
    ``cfg.apply_after_step`` (the JAX package multiplies by that gate;
    here the distance is not computed while the gate is shut)."""
    if global_step < cfg.apply_after_step:
        return pred_color.new_zeros(())
    flat_p = pred_color.reshape(-1, *pred_color.shape[2:])
    flat_t = target.reshape(flat_p.shape)
    return cfg.weight * lpips(flat_p, flat_t).mean()


def depth_supervision(
    cfg: LossDepthCfg,
    rendered_depth: torch.Tensor,  # (b, v, h, w) rendered target depth
    gt_depth: Optional[torch.Tensor],  # (b, v, h, w) sensor depth (m), 0 = invalid
    intrinsics: torch.Tensor,  # (b, v, 3, 3) normalized target intrinsics
    enc_depth: Optional[torch.Tensor] = None,  # (b, vc, h, w) context pred depth
    ctx_extrinsics: Optional[torch.Tensor] = None,  # (b, vc, 4, 4) c2w
    ctx_intrinsics: Optional[torch.Tensor] = None,  # (b, vc, 3, 3) normalized
) -> dict[str, torch.Tensor]:
    """Weighted auxiliary depth-loss terms; a term whose weight is 0 is not
    computed at all."""
    parts: dict[str, torch.Tensor] = {}
    if gt_depth is not None and (
        cfg.ms_gradient_weight or cfg.scale_invariant_weight or cfg.normals_weight
    ):
        b, v, h, w = rendered_depth.shape
        pred = rendered_depth.reshape(b * v, h, w)
        gt = gt_depth.reshape(b * v, h, w)
        valid = gt > 0
        # Invalid sensor pixels (0) -> NaN for the losses that mask
        # non-finite values (the reference feeds depth with NaN holes).
        gt_nan = torch.where(valid, gt, torch.full_like(gt, float("nan")))
        if cfg.ms_gradient_weight:
            parts["depth_grad"] = cfg.ms_gradient_weight * ms_gradient_loss(gt_nan, pred)
        if cfg.scale_invariant_weight:
            eps = torch.full_like(pred, 1e-6)
            log_gt = torch.log(torch.maximum(gt, eps))
            log_pr = torch.log(torch.maximum(pred, eps))
            parts["depth_si"] = cfg.scale_invariant_weight * scale_invariant_loss(
                log_gt, log_pr, mask=valid)
        if cfg.normals_weight:
            # One shared pixel-unit K (all views of a scene share
            # intrinsics in every dataset here).
            px = torch.tensor([w, h, 1.0], dtype=torch.float32, device=pred.device)
            k_px = intrinsics.reshape(-1, 3, 3)[0] * px[:, None]
            parts["depth_normals"] = cfg.normals_weight * normals_loss(
                depth_to_normals(gt_nan, k_px), depth_to_normals(pred, k_px))
    if cfg.mv_consistency_weight and enc_depth is not None:
        # Consecutive context-view pairs (the reference iterates the
        # cost-volume source views; consecutive pairs are the static-shape
        # equivalent for the sequential ScanNet trajectories).
        b, vc, h, w = enc_depth.shape
        if vc >= 2:
            px = torch.tensor([w, h, 1.0], dtype=torch.float32, device=enc_depth.device)
            k_px = ctx_intrinsics[0, 0] * px[:, None]
            parts["depth_mv"] = cfg.mv_consistency_weight * mv_depth_loss(
                enc_depth[:, :-1].reshape(-1, h, w), enc_depth[:, 1:].reshape(-1, h, w),
                ctx_extrinsics[:, :-1].reshape(-1, 4, 4), ctx_extrinsics[:, 1:].reshape(-1, 4, 4),
                k_px,
            )
    return parts


def total_loss(
    cfg: LossCfg,
    pred_color: torch.Tensor,  # (b, v, h, w, 3)
    target: torch.Tensor,
    global_step: int,
    lpips: Optional[torch.nn.Module] = None,
    depth_ctx: Optional[dict] = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    parts: dict[str, torch.Tensor] = {}
    total = pred_color.new_zeros(())
    if cfg.mse is not None:
        parts["mse"] = mse_loss(cfg.mse, pred_color, target)
        total = total + parts["mse"]
    if cfg.lpips is not None and lpips is not None:
        parts["lpips"] = lpips_loss(cfg.lpips, lpips, pred_color, target, global_step)
        total = total + parts["lpips"]
    if cfg.depth is not None and depth_ctx is not None:
        for k, v in depth_supervision(cfg.depth, **depth_ctx).items():
            parts[k] = v
            total = total + v
    return total, parts
