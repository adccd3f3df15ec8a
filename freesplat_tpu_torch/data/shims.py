"""Data shim: rescale + crop and the depth pyramid.

The crop shim of ``freesplat_tpu/data/shims.py`` (numpy and PIL only),
what the ScanNet loader applies.  Parity target:
``src/dataset/shims/crop_shim.py`` (LANCZOS rescale + center crop +
intrinsics fix-up + depth pyramid ``depth_s{-1..3}``, with the 1.5% depth
overscale at ``:75-77``).  The augmentation, patch and bounds shims (the
last one RE10K's) are not ported yet.

These run on the host (numpy/PIL), matching the reference's dataloader-
worker placement; images are NHWC float32.
"""
from __future__ import annotations

import numpy as np
from PIL import Image


def _rescale_image(image: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """(h, w, c) float -> LANCZOS resize (reference rescale uses PIL LANCZOS)."""
    h, w = shape
    pil = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
    out = pil.resize((w, h), Image.LANCZOS)
    return np.asarray(out).astype(np.float32) / 255.0


def _rescale_depth(depth: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor depth resize (no interpolation across edges)."""
    h, w = shape
    pil = Image.fromarray(depth.astype(np.float32), mode="F")
    out = pil.resize((w, h), Image.NEAREST)
    return np.asarray(out).astype(np.float32)


def _center_crop(
    images: np.ndarray,  # (v, hs, ws, c)
    intrinsics: np.ndarray,  # (v, 3, 3) normalized
    shape: tuple[int, int],
):
    v, h_in, w_in = images.shape[:3]
    h_out, w_out = shape
    row = (h_in - h_out) // 2
    col = (w_in - w_out) // 2
    images = images[:, row : row + h_out, col : col + w_out]
    intr = intrinsics.copy()
    # Normalized intrinsics: growing relative focal length under crop.
    intr[:, 0, 0] *= w_in / w_out
    intr[:, 1, 1] *= h_in / h_out
    # Principal point: convert to pixels, shift, renormalize.
    intr[:, 0, 2] = (intrinsics[:, 0, 2] * w_in - col) / w_out
    intr[:, 1, 2] = (intrinsics[:, 1, 2] * h_in - row) / h_out
    return images, intr


def rescale_and_crop(
    images: np.ndarray,  # (v, h, w, c) or (v, h, w) for depth
    intrinsics: np.ndarray,
    shape: tuple[int, int],
    is_depth: bool = False,
    overscale: bool = False,
):
    """Scale to cover ``shape`` then center crop (crop_shim.py:60-92)."""
    is_2d = images.ndim == 3
    if is_2d:
        images = images[..., None]
    v, h_in, w_in, c = images.shape
    h_out, w_out = shape
    factor = max(h_out / h_in, w_out / w_in)
    if overscale:
        factor = max(1.015 * h_out / h_in, 1.015 * w_out / w_in)
    h_s, w_s = round(h_in * factor), round(w_in * factor)
    if is_depth:
        scaled = np.stack([_rescale_depth(im[..., 0], (h_s, w_s)) for im in images])
        scaled = scaled[..., None]
    else:
        scaled = np.stack([_rescale_image(im, (h_s, w_s)) for im in images])
    out, intr = _center_crop(scaled, intrinsics, shape)
    if is_2d:
        out = out[..., 0]
    return out, intr


def apply_crop_shim_to_views(views: dict, shape: tuple[int, int]) -> dict:
    has_depth = "depth" in views
    images, intr = rescale_and_crop(
        views["image"], views["intrinsics"], shape, overscale=has_depth
    )
    out = {**views, "image": images, "intrinsics": intr}
    if has_depth:
        depth, _ = rescale_and_crop(
            views["depth"], views["intrinsics"], shape,
            is_depth=True, overscale=True,
        )
        out["depth"] = depth
        out["depth_s-1"] = depth
        for s in range(4):
            ds, _ = rescale_and_crop(
                views["depth"], views["intrinsics"],
                (shape[0] // (2 ** (s + 1)), shape[1] // (2 ** (s + 1))),
                is_depth=True, overscale=True,
            )
            out[f"depth_s{s}"] = ds
    return out


def apply_crop_shim(example: dict, shape: tuple[int, int]) -> dict:
    return {
        **example,
        "context": apply_crop_shim_to_views(example["context"], shape),
        "target": apply_crop_shim_to_views(example["target"], shape),
    }

