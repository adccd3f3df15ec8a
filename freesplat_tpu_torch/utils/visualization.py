"""Visualization utilities: layout, labels, colormaps, drawing, video.

A copy of ``freesplat_tpu/utils/visualization.py`` (numpy and PIL only;
the colormap tables are copied into ``utils/colormaps.py``, so no
matplotlib).  Parity targets: ``src/visualization/layout.py``
(hcat/vcat/add_border), ``annotation.py`` (add_label), ``color_map.py``
(apply_color_map), ``drawing/{lines,points}.py`` and the depth-colormap
helper ``model_wrapper.py:51-71``.  Images are (h, w, 3) float32 in
[0, 1].
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont


def get_distinct_color(index: int) -> tuple[float, float, float]:
    """Deterministic well-separated label colors (reference
    ``colors.py:30-32`` draws from a fixed hex palette; we golden-angle
    step the hue wheel instead — unbounded index, no stored table)."""
    import colorsys

    hue = (index * 0.38196601125) % 1.0  # golden-ratio conjugate
    sat = (0.65, 0.85)[index % 2]
    val = (0.95, 0.75)[(index // 2) % 2]
    return colorsys.hsv_to_rgb(hue, sat, val)


def as_numpy(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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


def add_border(image: np.ndarray, border: int = 8, color: float = 1.0) -> np.ndarray:
    image = _to_float(image)
    return np.pad(
        image, ((border, border), (border, border), (0, 0)),
        constant_values=color,
    )


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


def draw_points(
    image: np.ndarray,
    points_xy: np.ndarray,  # (n, 2) normalized [0, 1]
    color: Sequence[float] = (1.0, 0.0, 0.0),
    radius: int = 2,
) -> np.ndarray:
    """Overlay points (drawing/points.py equivalent)."""
    image = _to_float(image).copy()
    h, w = image.shape[:2]
    pil = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
    draw = ImageDraw.Draw(pil)
    rgb = tuple(int(c * 255) for c in color)
    for x, y in np.asarray(points_xy):
        px, py = x * w, y * h
        draw.ellipse(
            (px - radius, py - radius, px + radius, py + radius), fill=rgb
        )
    return np.asarray(pil).astype(np.float32) / 255.0


def draw_lines(
    image: np.ndarray,
    starts_xy: np.ndarray,  # (n, 2) normalized
    ends_xy: np.ndarray,
    color: Sequence[float] = (1.0, 0.0, 0.0),
    width: int = 1,
) -> np.ndarray:
    """Overlay line segments (drawing/lines.py equivalent)."""
    image = _to_float(image).copy()
    h, w = image.shape[:2]
    pil = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
    draw = ImageDraw.Draw(pil)
    rgb = tuple(int(c * 255) for c in color)
    for (x0, y0), (x1, y1) in zip(np.asarray(starts_xy), np.asarray(ends_xy)):
        draw.line((x0 * w, y0 * h, x1 * w, y1 * h), fill=rgb, width=width)
    return np.asarray(pil).astype(np.float32) / 255.0


def save_video(frames: Iterable[np.ndarray], path, fps: int = 30) -> None:
    """Dump frames as an animated GIF (no ffmpeg in this image).

    Callers may pass reference-style ``.mp4`` names (model_wrapper logs
    mp4 videos); PIL cannot encode mp4, so the suffix is rewritten to
    ``.gif`` rather than crashing a training run mid-validation."""
    path = Path(path)
    if path.suffix.lower() not in (".gif", ".webp", ".png"):
        path = path.with_suffix(".gif")
    path.parent.mkdir(parents=True, exist_ok=True)
    pils = [
        Image.fromarray((np.clip(_to_float(f), 0, 1) * 255).astype(np.uint8))
        for f in frames
    ]
    pils[0].save(
        path, save_all=True, append_images=pils[1:],
        duration=int(1000 / fps), loop=0,
    )
