"""The rasterizer kernels' operations and bytes, from the inputs alone.

The pairs come from the benchmark's own plain compositor
(``reference/render.py::composite`` with ``count_pairs``), under the 3-sigma
tile rectangle, alpha >= 1/255 and T >= 1e-4 rules, over one view's
Gaussians.  Operations per pair follow the compositing arithmetic, not
any kernel's instructions:

- forward, each pair evaluated: the offset (2), the conic's quadratic form
  (9), alpha = min(opacity exp(power), 0.99) (3) and the two cuts (2): 16;
  each pair blended besides: log1p, the running log T, exp, the T test,
  the weight and four weighted channel sums (4 x 2): 13; each pair that
  ends a pixel: log1p, the running log T, exp and the T test: 4;
- backward, each pair walked (a pixel's list up to its last blend): the
  forward's 16 again, T before the pair (3), the weight (1), the
  cotangent's channel dot (7), dalpha (4), dpower (1), the six
  second-moment terms and four color terms (10) and the ten running sums
  (10): 52.

Bytes, each input read once and each output written once: a visible
Gaussian's screen row is 10 float32 (mean 2, conic 3, opacity, color 3,
depth); a pixel's forward output 5 float32 (color 3, depth, log T).  The
backward reads the rows, the forward output and its cotangent, and writes
a gradient row per Gaussian.
"""
from __future__ import annotations

FWD_EVAL, FWD_BLEND, FWD_STOP = 16, 13, 4
BWD_WALK = 52
ROW_BYTES = 10 * 4
PIXEL_BYTES = 5 * 4


def forward(counts: dict) -> tuple[float, float]:
    """(operations, bytes) of one view's forward composite, from
    ``composite``'s counts (``rows``: the Gaussians that touch a tile)."""
    ops = (FWD_EVAL * counts["evaluated"] + FWD_BLEND * counts["blended"]
           + FWD_STOP * counts["stopped"])
    return float(ops), float(counts["rows"] * ROW_BYTES + counts["pixels"] * PIXEL_BYTES)


def backward(counts: dict) -> tuple[float, float]:
    """(operations, bytes) of one view's backward composite."""
    return (float(BWD_WALK * counts["walked"]),
            float(2 * counts["rows"] * ROW_BYTES + 2 * counts["pixels"] * PIXEL_BYTES))
