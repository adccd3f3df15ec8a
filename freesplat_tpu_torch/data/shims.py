"""Data shims: rescale + crop and the depth pyramid; augmentation, patch
and bounds shims.

A copy of ``freesplat_tpu/data/shims.py`` (numpy and PIL only).  Parity
targets: ``src/dataset/shims/crop_shim.py`` (LANCZOS rescale + center
crop + intrinsics fix-up + depth pyramid ``depth_s{-1..3}``, with the 1.5%
depth overscale at ``:75-77``), what the ScanNet and RE10K loaders apply;
``augmentation_shim.py`` (horizontal flip with extrinsics reflection,
disabled in the reference's configs), ``patch_shim.py`` and
``bounds_shim.py`` (disparity-derived near/far), which no preset applies.

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


def apply_augmentation_shim(example: dict, rng: np.random.Generator) -> dict:
    """Horizontal flip with extrinsics reflection (augmentation_shim.py:27-47).

    Disabled by default in the reference configs; kept for parity."""
    if rng.random() >= 0.5:
        return example

    reflect = np.diag([-1.0, 1.0, 1.0, 1.0]).astype(np.float32)

    def flip_views(views: dict) -> dict:
        out = dict(views)
        out["image"] = views["image"][:, :, ::-1].copy()
        intr = views["intrinsics"].copy()
        intr[:, 0, 2] = 1.0 - intr[:, 0, 2]
        out["intrinsics"] = intr
        extr = views["extrinsics"].copy()
        out["extrinsics"] = (reflect @ extr @ reflect).astype(np.float32)
        if "depth" in views:
            out["depth"] = views["depth"][:, :, ::-1].copy()
        return out

    return {
        **example,
        "context": flip_views(example["context"]),
        "target": flip_views(example["target"]),
    }


def apply_patch_shim_to_views(views: dict, patch_size: int) -> dict:
    """Center-crop so image dims divide the patch size (patch_shim.py)."""
    v, h, w = views["image"].shape[:3]
    h_new = (h // patch_size) * patch_size
    w_new = (w // patch_size) * patch_size
    row = (h - h_new) // 2
    col = (w - w_new) // 2
    image = views["image"][:, row : row + h_new, col : col + w_new]
    intr = views["intrinsics"].copy()
    intr[:, 0, 0] *= w / w_new
    intr[:, 1, 1] *= h / h_new
    return {**views, "image": image, "intrinsics": intr}


def apply_patch_shim(example: dict, patch_size: int) -> dict:
    return {
        **example,
        "context": apply_patch_shim_to_views(example["context"], patch_size),
        "target": apply_patch_shim_to_views(example["target"], patch_size),
    }


def compute_depth_for_disparity(
    extrinsics: np.ndarray,  # (v, 4, 4)
    intrinsics: np.ndarray,  # (v, 3, 3) normalized
    image_shape: tuple[int, int],
    disparity: float,
    delta_min: float = 1e-6,
) -> float:
    """Depth at which the max camera baseline subtends ``disparity`` pixels
    (bounds_shim.py)."""
    origins = extrinsics[:, :3, 3]
    deltas = np.linalg.norm(origins[None] - origins[:, None], axis=-1)
    baseline = max(deltas.max(), delta_min)
    h, w = image_shape
    pixel = np.array([1.0 / w, 1.0 / h], np.float32)
    sizes = np.einsum(
        "vij,j->vi", np.linalg.inv(intrinsics[:, :2, :2]), pixel
    )
    mean_pixel_size = float(sizes.mean())
    return float(baseline / (disparity * mean_pixel_size))


def apply_bounds_shim(
    example: dict, near_disparity: float, far_disparity: float
) -> dict:
    """Disparity-derived near/far planes (bounds_shim.py — used by RE10K)."""
    ctx = example["context"]
    v, h, w = ctx["image"].shape[:3]
    near = compute_depth_for_disparity(
        ctx["extrinsics"], ctx["intrinsics"], (h, w), near_disparity
    )
    far = compute_depth_for_disparity(
        ctx["extrinsics"], ctx["intrinsics"], (h, w), far_disparity
    )

    def with_bounds(views):
        n = views["image"].shape[0]
        return {
            **views,
            "near": np.full(n, near, np.float32),
            "far": np.full(n, far, np.float32),
        }

    return {
        **example,
        "context": with_bounds(example["context"]),
        "target": with_bounds(example["target"]),
    }
