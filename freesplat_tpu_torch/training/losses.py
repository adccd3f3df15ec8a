"""Training losses: MSE + LPIPS.

Port of ``freesplat_tpu/training/losses.py``: each loss is a function of
(prediction, target, step) plus the LPIPS module, and ``total_loss``
composes them per config into the same ``parts`` dict.  The auxiliary
depth losses are not ported yet: every preset leaves their weights at 0,
and a non-zero weight raises.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..config.config import LossCfg, LossDepthCfg, LossLpipsCfg, LossMseCfg

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


def depth_supervision(cfg: LossDepthCfg, **depth_ctx: Any) -> dict[str, torch.Tensor]:
    """The auxiliary depth losses: not ported yet, so any non-zero weight
    raises (every preset sets all four to 0)."""
    weights = {
        "ms_gradient_weight": cfg.ms_gradient_weight,
        "scale_invariant_weight": cfg.scale_invariant_weight,
        "normals_weight": cfg.normals_weight,
        "mv_consistency_weight": cfg.mv_consistency_weight,
    }
    asked = [k for k, w in weights.items() if w]
    if asked:
        raise NotImplementedError(f"depth losses are not ported yet: loss.depth.{asked}")
    return {}


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
