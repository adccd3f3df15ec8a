"""Discrete probability distribution sampling.

Port of ``freesplat_tpu/ops/discrete_distribution.py`` (reference
``src/misc/discrete_probability_distribution.py``): inverse-CDF sampling
of bucket indices, and the top-k buckets.  The JAX package draws its
uniforms from ``jax.random``; here they come from a ``torch.Generator``,
or the caller passes them (``sample_discrete_distribution_at``), so a
test can feed JAX's draws.
"""
from __future__ import annotations

import torch


def _normalize(pdf: torch.Tensor, eps: float) -> torch.Tensor:
    return pdf / torch.clamp(pdf.sum(-1, keepdim=True), min=eps)


def sample_discrete_distribution_at(
    pdf: torch.Tensor,  # (..., bucket)
    uniforms: torch.Tensor,  # (..., sample) in [0, 1)
    eps: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucket indices at the given uniforms: (index (..., sample) int32,
    densities (..., sample), the normalized pdf at the samples)."""
    buckets = pdf.shape[-1]
    normalized = _normalize(pdf, eps)
    cdf = torch.cumsum(normalized, dim=-1)
    idx = torch.searchsorted(cdf.contiguous(), uniforms.to(cdf.dtype).contiguous(), right=False)
    idx = torch.clamp(idx, 0, buckets - 1)
    return idx.to(torch.int32), torch.gather(normalized, -1, idx)


def sample_discrete_distribution(
    pdf: torch.Tensor,  # (..., bucket)
    generator: torch.Generator | None,
    num_samples: int,
    eps: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample ``num_samples`` bucket indices from each row's pdf; returns
    (index (..., sample) int32, densities (..., sample))."""
    u = torch.rand((*pdf.shape[:-1], num_samples), generator=generator,
                   dtype=pdf.dtype, device=pdf.device)
    return sample_discrete_distribution_at(pdf, u, eps)


def gather_discrete_topk(
    pdf: torch.Tensor,  # (..., bucket)
    num_samples: int,
    eps: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k buckets by pdf mass; same return contract as sampling.

    ``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` does not promise an order, so a stable descending sort
    gives JAX's."""
    normalized = _normalize(pdf, eps)
    dens, idx = torch.sort(normalized, dim=-1, descending=True, stable=True)
    return idx[..., :num_samples].to(torch.int32), dens[..., :num_samples]
