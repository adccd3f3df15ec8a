"""Four-tap bilinear sampling with zero padding (F.grid_sample semantics).

Port of ``freesplat_tpu/ops/grid_sample.py::bilinear_sample``.  The JAX
package's ``pack_quad``/``bilinear_sample_packed`` are a TPU row-gather
device; the taps and weights here are computed in the same order, so the
results equal the packed sampler's to float32 rounding.  Coordinates are
pixel xy with centers at half-integers (coordinate p samples p - 0.5).
"""
from __future__ import annotations

import torch

from .gather import take_rows


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
    # A tap outside the map reads some row and weighs it 0 (the JAX
    # package reads the clamped edge pixel).  Here it reads a row of its
    # own, spread over the map: clamped taps would pile onto the edge
    # pixels, and in the backward one edge pixel would then sum the zero
    # gradients of a large share of all samples, one after another.
    spread = torch.arange(x0i.numel(), device=features.device).reshape(x0i.shape) % (h * w)

    def tap(xi, yi, weight):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = torch.where(inside, yi * w + xi, spread) + boff
        # take_rows: the gradient of a source pixel that many samples read
        # sums in a fixed order (``ops/gather.py``).
        rows = take_rows(flat, idx.reshape(-1)).reshape(*idx.shape, c)
        return rows * (weight * inside)[..., None]

    return (
        tap(x0i, y0i, (1 - wx) * (1 - wy))
        + tap(x0i + 1, y0i, wx * (1 - wy))
        + tap(x0i, y0i + 1, (1 - wx) * wy)
        + tap(x0i + 1, y0i + 1, wx * wy)
    )
