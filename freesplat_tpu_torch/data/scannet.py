"""ScanNet / Replica scene-directory datasets (host-side, numpy).

Parity targets: ``src/dataset/dataset_scannet.py`` and
``dataset_replica.py``.  Scene layout on disk:

  <root>/<stage>/<scene>/color/<i>.jpg          RGB frames
  <root>/<stage>/<scene>/depth/<i>.png          depth in millimeters
  <root>/<stage>/<scene>/intrinsic/intrinsic_color.txt   4x4 (or 3x3) K
  <root>/<stage>/<scene>/extrinsics.npy         (n, 4, 4) c2w poses
  <root>/{train,test}_idx.txt                   scene lists

Frames are resized to 640x480, intrinsics normalized by image size, depth
converted mm -> meters (fp16 in the reference; fp32 here), then the crop
shim produces the training resolution + depth pyramid.  Replica shares the
layout (test-only / zero-shot, with FVS extrapolation targets).

A copy of ``freesplat_tpu/data/scannet.py``.  Frames and depth maps are
decoded by the threaded C++ decoder (``freesplat_tpu_torch/native``) when
it built, else by PIL, as in JAX; unlike JAX, a decoder that built and then
fails on a file raises instead of decoding the batch again with PIL.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from .. import native
from .shims import apply_crop_shim
from .view_samplers import ViewSampler


@dataclass
class DatasetScannetCfg:
    roots: Sequence[str] = ("datasets/scannet",)
    image_shape: tuple[int, int] = (384, 512)
    near: float = 0.5
    far: float = 15.0
    load_depth: bool = True
    overfit_to_scene: Optional[str] = None
    load_size: tuple[int, int] = (480, 640)  # (h, w) pre-crop resize


class DatasetScannet:
    """Map-style dataset over scene directories."""

    def __init__(
        self,
        cfg: DatasetScannetCfg,
        stage: str,
        view_sampler: ViewSampler,
    ) -> None:
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.scenes: list[Path] = []
        data_stage = "test" if stage in ("val", "test") else "train"
        for root in cfg.roots:
            root = Path(root)
            idx_file = root / f"{data_stage}_idx.txt"
            if idx_file.exists():
                names = [x for x in idx_file.read_text().split("\n") if x]
            elif (root / data_stage).is_dir():
                names = sorted(os.listdir(root / data_stage))
            else:
                continue
            self.scenes.extend(root / data_stage / n for n in names)
        if cfg.overfit_to_scene is not None:
            match = [p for p in self.scenes if p.name == cfg.overfit_to_scene]
            if match:
                self.scenes = match * max(len(self.scenes), 1)

    def __len__(self) -> int:
        return len(self.scenes)

    def _load_frames(self, path: Path, indices) -> np.ndarray:
        """Batched frame load: the native decoder (Lanczos) when it built,
        PIL's default resize otherwise."""
        h, w = self.cfg.load_size
        paths = [path / "color" / f"{int(i)}.jpg" for i in indices]
        if native.available():
            return native.load_jpeg_batch([str(p) for p in paths], h, w)
        return np.stack(
            [
                np.asarray(Image.open(p).resize((w, h))).astype(np.float32)
                / 255.0
                for p in paths
            ]
        )

    def _load_depths(self, path: Path, indices) -> np.ndarray:
        """Batched depth load (mm -> meters): the native decoder when it
        built, PIL otherwise (both bicubic)."""
        h, w = self.cfg.load_size
        paths = [path / "depth" / f"{int(i)}.png" for i in indices]
        if native.available():
            return native.load_depth_batch([str(p) for p in paths], h, w) / 1000.0
        return np.stack(
            [
                np.asarray(Image.open(p).resize((w, h))).astype(np.float32)
                / 1000.0
                for p in paths
            ]
        )

    def _scene_and_path(self, idx: int):
        """(eval-index scene key, on-disk scene dir).  Test-set keys may
        carry an `_N` eval suffix (reference :231-233): ScanNet strips it
        only when the suffixed dir is missing (Replica overrides)."""
        path = self.scenes[idx]
        scene = path.name
        if not path.exists() and path.with_name(scene[:-2]).exists():
            path = path.with_name(scene[:-2])
        return scene, path

    def __getitem__(self, idx: int) -> dict:
        scene, path = self._scene_and_path(idx)

        extrinsics = np.load(path / "extrinsics.npy").astype(np.float32)
        k = np.loadtxt(path / "intrinsic" / "intrinsic_color.txt").astype(
            np.float32
        )[:3, :3]
        n = extrinsics.shape[0]
        intrinsics = np.tile(k, (n, 1, 1))

        ctx_idx, tgt_idx, fvs_length = self.view_sampler.sample(
            scene, extrinsics, intrinsics
        )

        # Normalize intrinsics by the native color image size.
        probe = Image.open(path / "color" / "0.jpg")
        w0, h0 = probe.size
        intrinsics[:, 0] /= w0
        intrinsics[:, 1] /= h0

        def make_views(indices: np.ndarray) -> dict:
            images = self._load_frames(path, indices)
            views = {
                "extrinsics": extrinsics[indices],
                "intrinsics": intrinsics[indices],
                "image": images,
                "near": np.full(len(indices), self.cfg.near, np.float32),
                "far": np.full(len(indices), self.cfg.far, np.float32),
                "index": np.asarray(indices, np.int64),
            }
            if self.cfg.load_depth:
                views["depth"] = self._load_depths(path, indices)
            return views

        example = {
            "scene": scene,
            "context": make_views(ctx_idx),
            "target": {**make_views(tgt_idx), "test_fvs": fvs_length},
        }
        return apply_crop_shim(example, tuple(self.cfg.image_shape))


def collate(examples: list[dict]) -> dict:
    """Stack host examples into a batch (adds the leading b dim)."""
    def stack_views(key):
        views = [e[key] for e in examples]
        out = {}
        for k in views[0]:
            if k == "test_fvs":
                out[k] = views[0][k]
                continue
            out[k] = np.stack([np.asarray(v[k]) for v in views])
        return out

    return {
        "context": stack_views("context"),
        "target": stack_views("target"),
        "scene": [e["scene"] for e in examples],
    }

