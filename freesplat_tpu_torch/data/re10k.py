"""RealEstate10K chunked dataset (reference ``src/dataset/dataset_re10k.py``).

Port of ``freesplat_tpu/data/re10k.py``.  Chunks are ``.torch`` files,
each a list of scene dicts:
  {"key": str, "cameras": (n, 18) float32, "images": [jpeg bytes, ...]}
read with ``torch.load(weights_only=True)`` (the JAX package has its own
torch-free reader).  Camera rows are (fx, fy, cx, cy, _, _,
w2c_3x4_flat...) with normalized intrinsics (``convert_poses``, reference
``:154-175``).  Scenes wider than ``max_fov`` or with frames of another
shape than ``expected_shape`` are skipped (``:104,119-127``).

One difference from JAX: a scene the view sampler cannot serve is skipped
on ``KeyError`` as well as ``ValueError``.  The evaluation sampler raises
``KeyError`` for a scene its index lacks (the RE10K index maps some scenes
to null, which the sampler drops), where JAX stops the whole stream;
upstream pixelSplat's evaluation sampler raises ``ValueError`` there and
its loader skips the scene.
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch
from PIL import Image

from .shims import apply_crop_shim
from .view_samplers import ViewSampler


@dataclass
class DatasetRE10kCfg:
    roots: Sequence[str] = ("datasets/re10k",)
    image_shape: tuple[int, int] = (256, 256)
    near: float = 1.0
    far: float = 100.0
    max_fov: float = 100.0  # degrees; skip wider examples
    expected_shape: tuple[int, int] = (360, 640)  # native (h, w)
    skip_wrong_shape: bool = True


def convert_poses(poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n, 18) packed rows -> (extrinsics c2w (n, 4, 4), intrinsics (n, 3, 3))."""
    n = poses.shape[0]
    intrinsics = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    fx, fy, cx, cy = poses[:, 0], poses[:, 1], poses[:, 2], poses[:, 3]
    intrinsics[:, 0, 0] = fx
    intrinsics[:, 1, 1] = fy
    intrinsics[:, 0, 2] = cx
    intrinsics[:, 1, 2] = cy
    w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2c[:, :3] = poses[:, 6:].reshape(n, 3, 4)
    return np.linalg.inv(w2c), intrinsics


def _decode_image(blob) -> np.ndarray:
    data = bytes(np.asarray(blob, dtype=np.uint8))
    img = Image.open(io.BytesIO(data))
    return np.asarray(img).astype(np.float32) / 255.0


def load_chunk(path: str | Path) -> list[dict]:
    """One ``.torch`` chunk as a list of scene dicts (tensors as numpy)."""
    def numpy(x):
        if torch.is_tensor(x):
            return x.numpy()
        return [numpy(v) for v in x] if isinstance(x, list) else x

    chunk = torch.load(path, map_location="cpu", weights_only=True)
    return [{k: numpy(v) for k, v in scene.items()} for scene in chunk]


class DatasetRE10k:
    """Iterable over .torch chunks (shuffled chunk order per pass)."""

    def __init__(
        self,
        cfg: DatasetRE10kCfg,
        stage: str,
        view_sampler: ViewSampler,
        seed: int = 0,
    ) -> None:
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.rng = np.random.default_rng(seed)
        data_stage = "test" if stage in ("val", "test") else "train"
        self.chunk_paths: list[Path] = []
        for root in cfg.roots:
            stage_dir = Path(root) / data_stage
            if stage_dir.is_dir():
                self.chunk_paths.extend(sorted(stage_dir.glob("*.torch")))

    def _fov_ok(self, intrinsics: np.ndarray) -> bool:
        fov_x = 2 * np.degrees(np.arctan(0.5 / intrinsics[0, 0, 0]))
        return fov_x <= self.cfg.max_fov

    def examples(self) -> Iterator[dict]:
        order = self.rng.permutation(len(self.chunk_paths))
        for ci in order:
            for scene in load_chunk(self.chunk_paths[ci]):
                extrinsics, intrinsics = convert_poses(
                    np.asarray(scene["cameras"], np.float32)
                )
                if not self._fov_ok(intrinsics):
                    continue  # skip wide-FoV examples (reference :104)
                try:
                    ctx_idx, tgt_idx, fvs = self.view_sampler.sample(
                        scene["key"], extrinsics, intrinsics
                    )
                except (KeyError, ValueError):
                    continue  # not in the index, or too few frames
                images = {}
                skip = False
                for i in np.concatenate([ctx_idx, tgt_idx]):
                    img = _decode_image(scene["images"][int(i)])
                    if (
                        self.cfg.skip_wrong_shape
                        and img.shape[:2] != self.cfg.expected_shape
                    ):
                        skip = True
                        break
                    images[int(i)] = img
                if skip:
                    continue  # wrong-shape example (reference :119-127)

                def views(indices):
                    return {
                        "extrinsics": extrinsics[indices],
                        "intrinsics": intrinsics[indices],
                        "image": np.stack([images[int(i)] for i in indices]),
                        "near": np.full(len(indices), self.cfg.near, np.float32),
                        "far": np.full(len(indices), self.cfg.far, np.float32),
                        "index": np.asarray(indices, np.int64),
                    }

                example = {
                    "scene": scene["key"],
                    "context": views(ctx_idx),
                    "target": {**views(tgt_idx), "test_fvs": fvs},
                }
                yield apply_crop_shim(example, tuple(self.cfg.image_shape))
