"""Small numeric helpers shared across ops and models."""
from __future__ import annotations

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize along the last axis with finite gradients at x = 0."""
    sq = (x * x).sum(-1, keepdim=True)
    return x / torch.sqrt(sq + eps)
