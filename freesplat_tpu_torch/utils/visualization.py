"""Visualization utilities: image layout, labels and depth colormaps.

What validation and the test harness use of
``freesplat_tpu/utils/visualization.py``, copied (numpy and PIL only; the
colormap tables are copied into ``utils/colormaps.py``, so no matplotlib).
Parity targets: ``src/visualization/layout.py`` (hcat/vcat),
``annotation.py`` (add_label) and ``color_map.py`` (apply_color_map).
Images are (h, w, 3) float32 in [0, 1].  The drawing and video helpers
are not ported yet.
"""
from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw, ImageFont


def _to_float(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return image.astype(np.float32)


def hcat(*images: np.ndarray, align: str = "center", gap: int = 8,
         gap_color: float = 1.0) -> np.ndarray:
    """Concatenate horizontally, padding heights (layout.py's hcat)."""
    images = [_to_float(im) for im in images]
    h = max(im.shape[0] for im in images)
    padded = []
    for i, im in enumerate(images):
        dh = h - im.shape[0]
        top = {"start": 0, "center": dh // 2, "end": dh}[align]
        padded.append(
            np.pad(im, ((top, dh - top), (0, 0), (0, 0)),
                   constant_values=gap_color)
        )
        if i < len(images) - 1:
            padded.append(np.full((h, gap, 3), gap_color, np.float32))
    return np.concatenate(padded, axis=1)


def vcat(*images: np.ndarray, align: str = "center", gap: int = 8,
         gap_color: float = 1.0) -> np.ndarray:
    images = [_to_float(im) for im in images]
    w = max(im.shape[1] for im in images)
    padded = []
    for i, im in enumerate(images):
        dw = w - im.shape[1]
        left = {"start": 0, "center": dw // 2, "end": dw}[align]
        padded.append(
            np.pad(im, ((0, 0), (left, dw - left), (0, 0)),
                   constant_values=gap_color)
        )
        if i < len(images) - 1:
            padded.append(np.full((gap, w, 3), gap_color, np.float32))
    return np.concatenate(padded, axis=0)


def add_label(image: np.ndarray, label: str, font_size: int = 14) -> np.ndarray:
    """Stack a text label above the image (annotation.py's add_label)."""
    image = _to_float(image)
    w = image.shape[1]
    bar_h = font_size + 8
    bar = Image.new("RGB", (w, bar_h), (255, 255, 255))
    draw = ImageDraw.Draw(bar)
    try:
        font = ImageFont.load_default(size=font_size)
    except TypeError:
        font = ImageFont.load_default()
    draw.text((4, 4), label, fill=(0, 0, 0), font=font)
    bar_arr = np.asarray(bar).astype(np.float32) / 255.0
    return np.concatenate([bar_arr, image], axis=0)


def apply_color_map(values: np.ndarray, cmap: str = "viridis") -> np.ndarray:
    """Scalar field in [0, 1] -> (..., 3) RGB float32 (color_map.py's
    apply_color_map), indexed as matplotlib's ``Colormap.__call__`` indexes
    floats: values clipped to [0, 1], row ``floor(x * 256)`` with 1.0 on
    the last row, NaN black."""
    from .colormaps import TABLES

    table = np.asarray(TABLES[cmap], np.float64)
    n = table.shape[0]
    x = np.clip(np.asarray(values, np.float32), 0.0, 1.0) * np.float32(n)
    bad = np.isnan(x)
    x[x == n] = n - 1
    idx = np.where(bad, 0, x).astype(np.int64)
    rgb = table[idx]
    rgb[bad] = 0.0
    return rgb.astype(np.float32)


def depth_to_color(
    depth: np.ndarray, near: float | None = None, far: float | None = None,
    cmap: str = "turbo",
) -> np.ndarray:
    """Depth colormap visualization (model_wrapper.py convert_array_to_pil).

    Normalizes by (near, far) or the finite positive value range, inverted
    so close is bright."""
    depth = np.asarray(depth, np.float32)
    finite = depth[np.isfinite(depth) & (depth > 0)]
    lo = near if near is not None else (finite.min() if finite.size else 0.0)
    hi = far if far is not None else (finite.max() if finite.size else 1.0)
    norm = np.clip((depth - lo) / max(hi - lo, 1e-8), 0.0, 1.0)
    return apply_color_map(1.0 - norm, cmap)
