"""Visualization utilities: image layout and labels.

What validation uses of ``freesplat_tpu/utils/visualization.py``, copied
(numpy and PIL only).  Parity targets: ``src/visualization/layout.py``
(hcat/vcat) and ``annotation.py`` (add_label).  Images are (h, w, 3)
float32 in [0, 1].  The colormaps, drawing and video helpers are not
ported yet.
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
