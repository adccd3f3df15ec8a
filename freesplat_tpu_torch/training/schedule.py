"""Optimizer + LR schedule.

Port of ``freesplat_tpu/training/schedule.py``: global-norm clipping,
then Adam whose learning rate follows ``make_schedule``.  optax's pieces
are written out so the update is the same:

- ``make_schedule`` is ``optax.cosine_onecycle_schedule`` (or the linear
  warm-up joined to a constant) as a plain function of the step.
  ``torch.optim.lr_scheduler.OneCycleLR`` is not used: its phase
  boundaries sit one step earlier (``pct_start * total - 1``, ``total - 1``).
- ``clip_grad_global_norm`` scales by ``max / |g|`` only when
  ``|g| > max``, with no epsilon (``clip_grad_norm_`` adds 1e-6).
- Adam is ``torch.optim.Adam(eps=1e-8)``, which is ``optax.adam``; the
  trainer sets the group's learning rate from the schedule each step, as
  optax evaluates it at the update count before incrementing it.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from ..config.config import OptimizerCfg

__all__ = ["OptimizerCfg", "clip_grad_global_norm", "make_optimizer", "make_schedule"]


def make_schedule(cfg: OptimizerCfg) -> Callable[[int], float]:
    if cfg.cosine_lr:
        # optax.piecewise_interpolate_schedule("cosine", lr / 25,
        #   {int(pct * T): 25, int(T): 1 / (25 * 1e4)})
        steps = cfg.max_steps
        pct = max(cfg.warm_up_steps, 1) / max(cfg.max_steps, 1)
        bounds = (0, int(pct * steps), int(steps))
        init = cfg.lr / 25.0
        values = (init, init * 25.0, init * 25.0 * (1.0 / (25.0 * 1e4)))

        def schedule(count: int) -> float:
            for i in range(2):
                if bounds[i] <= count < bounds[i + 1]:
                    frac = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                    start, end = values[i], values[i + 1]
                    return end + (start - end) / 2.0 * (math.cos(math.pi * frac) + 1)
            return values[2] if count >= bounds[2] else 0.0

        return schedule

    # optax.join_schedules([linear(lr / warm, lr, warm), constant(lr)], [warm])
    warm = cfg.warm_up_steps
    init = cfg.lr / max(warm, 1)

    def schedule(count: int) -> float:
        if count >= warm:
            return cfg.lr
        if warm <= 0:
            return init
        frac = 1 - min(max(count, 0), warm) / warm
        return (init - cfg.lr) * frac + cfg.lr

    return schedule


@torch.no_grad()
def clip_grad_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: returns the global norm.  No
    host sync: the scale is chosen on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    torch._foreach_mul_(grads, scale)
    return norm


def make_optimizer(cfg: OptimizerCfg, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=make_schedule(cfg)(0), betas=(0.9, 0.999), eps=1e-8)
