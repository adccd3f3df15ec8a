"""Offline evaluation-index generation via epipolar view overlap.

Port of ``freesplat_tpu/evaluation/index_generator.py`` (parity target
``src/evaluation/evaluation_index_generator.py:48-159`` +
``src/scripts/generate_evaluation_index.py``): per scene, pick a random
context view, walk outward until the pairwise epipolar overlap falls into
[min_overlap, max_overlap], choose a partner + random unique target views
in between, save the frozen index JSON.  The same numpy RNG draws in the
same order, so a seed gives the JAX package's index.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from ..geometry.epipolar import project_rays
from ..geometry.projection import get_world_rays, sample_image_grid
from ..utils.device import resolve_device


@dataclass
class IndexEntry:
    context: tuple[int, ...]
    target: tuple[int, ...]


@dataclass
class EvaluationIndexGeneratorCfg:
    num_target_views: int = 3
    min_distance: int = 10
    max_distance: int = 60
    min_overlap: float = 0.4
    max_overlap: float = 0.8
    output_path: str = "outputs/evaluation_index"
    subsample: int = 8  # ray-grid stride for the overlap estimate


@torch.no_grad()
def view_overlap(
    extr_a, intr_a, extr_b, intr_b, image_shape: tuple[int, int], stride: int = 8
) -> tuple[float, float]:
    """Fraction of each view's rays whose epipolar segment overlaps the
    other view's frame (both directions); on the cameras' device."""
    h, w = image_shape
    xy, _ = sample_image_grid((h // stride, w // stride), device=extr_a.device)
    xy = xy.reshape(-1, 2)

    def one_way(extr_src, intr_src, extr_dst, intr_dst):
        origins, directions = get_world_rays(xy, extr_src, intr_src)
        proj = project_rays(origins, directions, extr_dst, intr_dst)
        return float(proj.overlaps_image.float().mean())

    return (
        one_way(extr_b, intr_b, extr_a, intr_a),
        one_way(extr_a, intr_a, extr_b, intr_b),
    )


class EvaluationIndexGenerator:
    def __init__(self, cfg: EvaluationIndexGeneratorCfg, seed: int = 0,
                 device: str | torch.device = "cuda") -> None:
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.index: dict[str, IndexEntry | None] = {}

    def process_scene(
        self,
        scene: str,
        extrinsics: np.ndarray,  # (v, 4, 4)
        intrinsics: np.ndarray,  # (v, 3, 3) normalized
        image_shape: tuple[int, int],
    ) -> None:
        cfg = self.cfg
        v = extrinsics.shape[0]
        extr = torch.as_tensor(np.asarray(extrinsics, np.float32), device=self.device)
        intr = torch.as_tensor(np.asarray(intrinsics, np.float32), device=self.device)
        for context_index in self.rng.permutation(v):
            valid: list[int] = []
            for step in (1, -1):
                current = int(context_index) + step * cfg.min_distance
                while 0 <= current < v:
                    overlap_a, overlap_b = view_overlap(
                        extr[context_index], intr[context_index],
                        extr[current], intr[current],
                        image_shape, cfg.subsample,
                    )
                    overlap = min(overlap_a, overlap_b)
                    delta = abs(current - int(context_index))
                    if cfg.min_overlap <= overlap <= cfg.max_overlap:
                        valid.append(current)
                    if overlap < cfg.min_overlap or delta > cfg.max_distance:
                        break
                    current += step
            if valid:
                chosen = int(valid[self.rng.integers(len(valid))])
                left = min(chosen, int(context_index))
                right = max(chosen, int(context_index))
                span = np.arange(left, right + 1)
                n_targets = min(cfg.num_target_views, len(span))
                targets = self.rng.choice(span, size=n_targets, replace=False)
                self.index[scene] = IndexEntry(
                    context=(left, right),
                    target=tuple(sorted(int(t) for t in targets)),
                )
                return
        self.index[scene] = None

    def save_index(self, path: str | Path | None = None) -> Path:
        out = Path(path or self.cfg.output_path)
        out.mkdir(exist_ok=True, parents=True)
        file = out / "evaluation_index.json"
        with file.open("w") as f:
            json.dump(
                {
                    k: None if e is None else asdict(e)
                    for k, e in self.index.items()
                },
                f,
            )
        return file
