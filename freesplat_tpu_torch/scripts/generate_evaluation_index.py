"""CLI: generate frozen evaluation indices for a dataset.

Port of ``freesplat_tpu/scripts/generate_evaluation_index.py`` (parity
target ``src/scripts/generate_evaluation_index.py``): runs the
epipolar-overlap index generator over every scene of a ScanNet-layout
dataset root and writes ``evaluation_index.json``.

Run (the GPU unless ``main`` is asked for the CPU):
  python -m freesplat_tpu_torch.scripts.generate_evaluation_index \
      dataset.roots=[datasets/scannet] test.output_path=outputs/eval_index
"""
from __future__ import annotations

import sys

import numpy as np
from PIL import Image

from ..config.config import load_config
from ..data.scannet import DatasetScannet, DatasetScannetCfg
from ..data.view_samplers import ViewSamplerAll
from ..evaluation.index_generator import (
    EvaluationIndexGenerator,
    EvaluationIndexGeneratorCfg,
)


def main(argv: list[str] | None = None, device: str = "cuda"):
    """Index every scene of ``dataset.roots`` (test stage) with the overlap
    computed on ``device``; returns the written file's path."""
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    ds = DatasetScannet(
        DatasetScannetCfg(
            roots=tuple(cfg.dataset.roots),
            image_shape=cfg.dataset.image_shape,
            load_depth=False,
        ),
        "test",
        ViewSamplerAll(),
    )
    gen = EvaluationIndexGenerator(
        EvaluationIndexGeneratorCfg(output_path=cfg.test.output_path),
        seed=cfg.seed,
        device=device,
    )
    for path in ds.scenes:
        scene = path.name
        extr_file = path / "extrinsics.npy"
        if not extr_file.exists():
            continue
        extrinsics = np.load(extr_file).astype(np.float32)
        k = np.loadtxt(path / "intrinsic" / "intrinsic_color.txt").astype(
            np.float32
        )[:3, :3]
        # Normalize by the native image size.
        w0, h0 = Image.open(path / "color" / "0.jpg").size
        k = k.copy()
        k[0] /= w0
        k[1] /= h0
        intrinsics = np.tile(k, (extrinsics.shape[0], 1, 1))
        gen.process_scene(scene, extrinsics, intrinsics, cfg.dataset.image_shape)
        entry = gen.index[scene]
        print(f"{scene}: {entry}")
    out = gen.save_index()
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
