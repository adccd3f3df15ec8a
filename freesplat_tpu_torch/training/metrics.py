"""Evaluation metrics: PSNR, SSIM, depth metrics.  NHWC images in [0, 1].

Port of ``freesplat_tpu/training/metrics.py``: SSIM as skimage's
``structural_similarity(win_size=11, gaussian_weights=True,
data_range=1)``, and the rendered-vs-sensor depth metrics masked at
gt > 0.5.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import upload


def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) pairs -> (b,) PSNR in dB (inputs clipped to [0, 1])."""
    gt = torch.clamp(ground_truth, 0.0, 1.0)
    pr = torch.clamp(predicted, 0.0, 1.0)
    mse = ((gt - pr) ** 2).mean(dim=(-1, -2, -3))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _gaussian_kernel(win_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    offs = np.arange(win_size) - (win_size - 1) / 2.0
    k = np.exp(-0.5 * (offs / sigma) ** 2)
    k = k / k.sum()
    return np.outer(k, k).astype(np.float32)


def compute_ssim(
    ground_truth: torch.Tensor,
    predicted: torch.Tensor,
    win_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
) -> torch.Tensor:
    """(b, h, w, c) -> (b,) mean SSIM over the valid-window map.

    The window sums run in full float32: ``mu_xx - mu_x**2`` cancels for
    near-identical images, and TF32 (kept off by the package) would push
    SSIM above 1 there."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    gt = torch.clamp(ground_truth, 0.0, 1.0).float()
    pr = torch.clamp(predicted, 0.0, 1.0).float()
    b, h, w, c = gt.shape
    kernel = upload(_gaussian_kernel(win_size, sigma), gt.device, "metrics.compute_ssim")[None, None]

    def filt(x):
        # Per-channel VALID convolution: (b, h, w, c) -> (b * c, 1, oh, ow).
        return F.conv2d(x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w), kernel)

    mu_x, mu_y = filt(gt), filt(pr)
    mu_xx, mu_yy, mu_xy = filt(gt * gt), filt(pr * pr), filt(gt * pr)
    # skimage's unbiased covariances: n / (n - 1).
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    vx = cov_norm * (mu_xx - mu_x * mu_x)
    vy = cov_norm * (mu_yy - mu_y * mu_y)
    vxy = cov_norm * (mu_xy - mu_x * mu_y)
    a1 = 2 * mu_x * mu_y + c1
    a2 = 2 * vxy + c2
    b1 = mu_x * mu_x + mu_y * mu_y + c1
    b2 = vx + vy + c2
    ssim_map = (a1 * a2) / (b1 * b2)
    return ssim_map.reshape(b, -1).mean(dim=1)


def depth_metrics(
    gt_depth: torch.Tensor,  # (..., h, w) sensor depth (0 = invalid)
    pred_depth: torch.Tensor,  # (..., h, w)
    min_valid: float = 0.5,
) -> dict[str, torch.Tensor]:
    """abs_diff / abs_rel / delta<1.25 / delta<1.1, masked at gt > 0.5,
    averaged per map and then over maps."""
    gt = gt_depth.reshape(-1, gt_depth.shape[-2] * gt_depth.shape[-1])
    pr = pred_depth.reshape(gt.shape)
    mask = gt > min_valid
    cnt = torch.clamp(mask.sum(dim=1), min=1)

    def masked_mean(x):
        return torch.where(mask, x, torch.zeros_like(x)).sum(dim=1) / cnt

    one = torch.ones_like(gt)
    pr_safe = torch.where(mask & (pr > 0), pr, one)
    gt_safe = torch.where(mask, gt, one)
    thresh = torch.maximum(gt_safe / pr_safe, pr_safe / gt_safe)
    return {
        "abs_diff": masked_mean(torch.abs(gt_safe - pr_safe)).mean(),
        "abs_rel": masked_mean(torch.abs(gt_safe - pr_safe) / gt_safe).mean(),
        "delta_25": masked_mean((thresh < 1.25).float()).mean(),
        "delta_10": masked_mean((thresh < 1.10).float()).mean(),
    }
