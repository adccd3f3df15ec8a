"""Four-tap bilinear sampling with zero padding (F.grid_sample semantics).

Port of ``freesplat_tpu/ops/grid_sample.py::bilinear_sample``.  The JAX
package's ``pack_quad``/``bilinear_sample_packed`` are a TPU row-gather
device; the taps and weights here are computed in the same order, so the
results equal the packed sampler's to float32 rounding.  Coordinates are
pixel xy with centers at half-integers (coordinate p samples p - 0.5).
"""
from __future__ import annotations

import torch


def bilinear_sample(
    features: torch.Tensor,  # (..., h, w, c)
    coords: torch.Tensor,  # (..., n, 2) pixel xy
) -> torch.Tensor:
    """Returns (..., n, c); samples outside the map read zeros."""
    h, w, c = features.shape[-3:]
    batch_shape = features.shape[:-3]
    nb = 1
    for s in batch_shape:
        nb *= s
    x = coords[..., 0] - 0.5
    y = coords[..., 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = features.reshape(nb * h * w, c)
    boff = (h * w) * torch.arange(nb, device=features.device).reshape(
        *batch_shape, *([1] * (coords.dim() - 1 - len(batch_shape)))
    )

    def tap(xi, yi, weight):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1) + boff
        # index_select: its backward is index_add_ (atomics on the GPU),
        # where flat[idx]'s sorts the indices first.
        rows = flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c)
        return rows * (weight * inside)[..., None]

    return (
        tap(x0i, y0i, (1 - wx) * (1 - wy))
        + tap(x0i + 1, y0i, wx * (1 - wy))
        + tap(x0i, y0i + 1, (1 - wx) * wy)
        + tap(x0i + 1, y0i + 1, wx * wy)
    )
