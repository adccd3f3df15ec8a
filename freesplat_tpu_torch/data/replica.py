"""Replica zero-shot evaluation dataset (reference
``src/dataset/dataset_replica.py``).

Port of ``freesplat_tpu/data/replica.py``.  Replica shares ScanNet's
scene-directory layout (``data/scannet.py``) and is test-only (zero-shot
transfer of ScanNet-trained nets).  Its deltas against the ScanNet loader
(``dataset_replica.py:60-170``):

1. Test index keys carry an ``_N`` FVS-variant suffix (``office0_1``);
   in the val and test stages the scene directory is the stripped name
   whenever that directory exists (ScanNet strips only when the suffixed
   path is missing).
2. ``intrinsic/intrinsic_depth.txt``, normalized by the depth image's own
   size (Replica's depth camera has its own calibration), is attached as
   ``depth_intrinsics`` on the context and target views, one row per view.
"""
from __future__ import annotations

import numpy as np
from PIL import Image

from .scannet import DatasetScannet


class DatasetReplica(DatasetScannet):
    """Map-style Replica dataset: the ScanNet loader plus Replica's deltas."""

    def _scene_and_path(self, idx: int):
        path = self.scenes[idx]
        scene = path.name
        if (
            self.stage in ("val", "test")
            and len(scene) > 2
            and scene[-2] == "_"
            and path.with_name(scene[:-2]).exists()
        ):
            path = path.with_name(scene[:-2])
        return scene, path

    def __getitem__(self, idx: int) -> dict:
        example = super().__getitem__(idx)
        _, path = self._scene_and_path(idx)
        depth_k_path = path / "intrinsic" / "intrinsic_depth.txt"
        if depth_k_path.exists():
            dk = np.loadtxt(depth_k_path).astype(np.float32)[:3, :3]
            dw0, dh0 = Image.open(path / "depth" / "0.png").size
            dk[0] /= dw0
            dk[1] /= dh0
            for part in ("context", "target"):
                n = len(example[part]["index"])
                example[part]["depth_intrinsics"] = np.tile(dk, (n, 1, 1))
        return example
