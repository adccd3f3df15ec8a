"""Core model data contracts."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Gaussians(NamedTuple):
    """The encoder -> decoder Gaussian contract.

    means:       (*batch, g, 3)
    covariances: (*batch, g, 3, 3)
    harmonics:   (*batch, g, 3, d_sh)
    opacities:   (*batch, g)
    mask:        (*batch, g) bool or None (= all valid)
    """

    means: torch.Tensor
    covariances: torch.Tensor
    harmonics: torch.Tensor
    opacities: torch.Tensor
    mask: Optional[torch.Tensor] = None

    def masked_opacities(self) -> torch.Tensor:
        if self.mask is None:
            return self.opacities
        return torch.where(self.mask, self.opacities, 0.0)
