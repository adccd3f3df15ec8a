"""Dataset batch contract (reference ``src/dataset/types.py:16-28``).

A copy of ``freesplat_tpu/data/types.py``.  A batch is a nested dict of
numpy arrays (the scene loaders) or tensors (the synthetic stream):

  batch = {
    "context": {
      "extrinsics": (b, v, 4, 4) c2w OpenCV,
      "intrinsics": (b, v, 3, 3) normalized,
      "image":      (b, v, h, w, 3) float in [0, 1]   (NHWC — TPU layout),
      "near":       (b, v), "far": (b, v),
      "index":      (b, v) int,
      # optional: "depth": (b, v, h, w) sensor depth (0 = invalid)
    },
    "target": { same fields },
    "scene": list[str],
  }

The reference stores images CHW; this framework is NHWC end to end.
"""
from __future__ import annotations

from typing import Any, TypedDict


class Views(TypedDict, total=False):
    extrinsics: Any
    intrinsics: Any
    image: Any
    near: Any
    far: Any
    index: Any
    depth: Any


class Batch(TypedDict, total=False):
    context: Views
    target: Views
    scene: list
