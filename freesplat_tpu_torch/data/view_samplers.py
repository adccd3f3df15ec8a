"""View samplers: pick context/target frame indices per scene.

A copy of ``freesplat_tpu/data/view_samplers.py`` (numpy only).

Parity targets: ``src/dataset/view_sampler/`` — ``bounded`` (curriculum
gap schedule + random N-context chains with per-gap targets, FVT's
``random: True`` mode), ``evaluation`` (frozen JSON indices),
``arbitrary``, ``all``.  The reference drives the curriculum through a
shared-memory StepTracker because sampling happens in dataloader worker
processes; here sampling runs in the host loop so the step is just a
value set via ``set_step``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Protocol

import numpy as np


class ViewSampler(Protocol):
    def sample(
        self, scene: str, extrinsics: np.ndarray, intrinsics: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Returns (context_indices, target_indices, fvs_length)."""
        ...


@dataclass
class ViewSamplerBoundedCfg:
    num_context_views: int = 2
    num_target_views: int = 8
    min_distance_between_context_views: int = 20
    max_distance_between_context_views: int = 50
    min_distance_to_context_views: int = 5
    warm_up_steps: int = 150_000
    initial_min_distance_between_context_views: int = 10
    initial_max_distance_between_context_views: int = 20
    random: bool = False  # FVT: 2..num_context_views contexts per sample


class ViewSamplerBounded:
    """Curriculum chain sampler (``view_sampler_bounded.py:28-122``)."""

    def __init__(
        self, cfg: ViewSamplerBoundedCfg, stage: str = "train",
        is_overfitting: bool = False, seed: int = 1234,
    ) -> None:
        self.cfg = cfg
        self.stage = stage
        self.is_overfitting = is_overfitting
        self.global_step = 0
        self.rng = np.random.default_rng(seed)

    def set_step(self, step: int) -> None:
        self.global_step = int(step)

    def _schedule(self, initial: int, final: int) -> int:
        fraction = self.global_step / max(self.cfg.warm_up_steps, 1)
        return min(initial + int((final - initial) * fraction), final)

    def sample(self, scene, extrinsics, intrinsics):
        cfg = self.cfg
        num_views = extrinsics.shape[0]
        if self.stage == "test":
            max_gap = min_gap = cfg.max_distance_between_context_views
        elif cfg.warm_up_steps > 0:
            max_gap = self._schedule(
                cfg.initial_max_distance_between_context_views,
                cfg.max_distance_between_context_views,
            )
            min_gap = self._schedule(
                cfg.initial_min_distance_between_context_views,
                cfg.min_distance_between_context_views,
            )
        else:
            max_gap = cfg.max_distance_between_context_views
            min_gap = cfg.min_distance_between_context_views
        max_gap = min(num_views - 1, max_gap)
        min_gap = max(2 * cfg.min_distance_to_context_views, min_gap)
        if max_gap < min_gap:
            raise ValueError(f"scene {scene}: not enough frames")
        context_gap = int(self.rng.integers(min_gap, max_gap + 1))

        if cfg.random:
            n_ctx = int(self.rng.integers(2, cfg.num_context_views + 1))
        else:
            n_ctx = cfg.num_context_views
            if n_ctx > (num_views - 1) // context_gap + 1:
                raise ValueError(f"scene {scene}: not enough views for contexts")
        n_ctx = min(n_ctx, (num_views - 1) // context_gap + 1)

        hi = max(num_views - context_gap * (n_ctx - 1), 1)
        left = int(self.rng.integers(0, hi))
        if self.is_overfitting:
            left = 0

        per_size = {2: 4, 3: 2}.get(n_ctx, 1)
        contexts = [left]
        targets = []
        for i in range(n_ctx - 1):
            right = contexts[i] + context_gap
            lo = contexts[i] + cfg.min_distance_to_context_views
            hi_t = right - cfg.min_distance_to_context_views
            if hi_t <= lo:
                lo, hi_t = contexts[i] + 1, right
            targets.append(self.rng.integers(lo, hi_t, size=per_size))
            contexts.append(right)
        return (
            np.asarray(contexts, np.int64),
            np.concatenate(targets) if targets else np.asarray([], np.int64),
            0,
        )


@dataclass
class ViewSamplerEvaluationCfg:
    index_path: str = "assets/evaluation_index_scannet_2views.json"


class ViewSamplerEvaluation:
    """Frozen JSON eval indices (``view_sampler_evaluation.py:36-72``).

    JSON schema: {scene: {"context": [...], "target": [...],
    "extrapolation"?: [...]} | null}.
    """

    def __init__(self, cfg: ViewSamplerEvaluationCfg) -> None:
        self.cfg = cfg
        with open(cfg.index_path) as f:
            raw = json.load(f)
        self.index = {k: v for k, v in raw.items() if v is not None}

    def sample(self, scene, extrinsics, intrinsics):
        entry = self.index[scene]
        context = np.asarray(entry["context"], np.int64)
        target = np.asarray(entry["target"], np.int64)
        extrapolation = entry.get("extrapolation") or []
        fvs_length = len(extrapolation)
        if fvs_length:
            # Extrapolation targets are appended AFTER the interpolation
            # targets (reference view_sampler_evaluation.py:66-69; the
            # loaders and metrics take targets[length-fvs_length:] as the
            # extrapolation block, model_wrapper.py:427-443).
            target = np.concatenate(
                [target, np.asarray(extrapolation, np.int64)]
            )
        return context, target, fvs_length


@dataclass
class ViewSamplerArbitraryCfg:
    context_views: tuple[int, ...] = (0, 1)
    target_views: tuple[int, ...] = (2,)


class ViewSamplerArbitrary:
    def __init__(self, cfg: ViewSamplerArbitraryCfg) -> None:
        self.cfg = cfg

    def sample(self, scene, extrinsics, intrinsics):
        return (
            np.asarray(self.cfg.context_views, np.int64),
            np.asarray(self.cfg.target_views, np.int64),
            0,
        )


class ViewSamplerAll:
    def sample(self, scene, extrinsics, intrinsics):
        n = extrinsics.shape[0]
        idx = np.arange(n, dtype=np.int64)
        return idx, idx, 0


SAMPLERS = {
    "bounded": ViewSamplerBounded,
    "evaluation": ViewSamplerEvaluation,
    "arbitrary": ViewSamplerArbitrary,
    "all": ViewSamplerAll,
}
