"""Evaluation metrics (PSNR).  NHWC images in [0, 1]."""
from __future__ import annotations

import torch


def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) pairs -> (b,) PSNR in dB (inputs clipped to [0, 1])."""
    gt = torch.clamp(ground_truth, 0.0, 1.0)
    pr = torch.clamp(predicted, 0.0, 1.0)
    mse = ((gt - pr) ** 2).mean(dim=(-1, -2, -3))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
