"""Training runtime: the train step and its host loop.

Port of ``freesplat_tpu/training/trainer.py`` (single device; no mesh):
one ``train_step`` (encoder -> render -> loss -> backward -> global-norm
clip -> Adam at the scheduled learning rate) and ``fit``, the host loop
with the same callbacks, logging interval and dropped-instance warning.

The state is a dict: ``encoder`` (the module in ``train()`` mode; its
parameters and BN running buffers are the JAX state's ``params`` and
``batch_stats``), ``optimizer`` (``torch.optim.Adam``, the ``opt_state``)
and ``step`` (a Python int).  A step updates the encoder and the
optimizer in place and returns the state with the step advanced.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Mapping

import torch

from ..models.decoder import DecoderCfg, render_views
from ..models.encoder import EncoderFreeSplatCfg, make_encoder
from .losses import LossCfg, total_loss
from .metrics import compute_psnr
from .schedule import OptimizerCfg, clip_grad_global_norm, make_optimizer, make_schedule

_VIEW_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


@dataclass(frozen=True)
class TrainCfg:
    encoder: EncoderFreeSplatCfg = field(default_factory=EncoderFreeSplatCfg)
    decoder: DecoderCfg = field(default_factory=DecoderCfg)
    loss: LossCfg = field(default_factory=LossCfg)
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    log_every: int = 10


def init_state(cfg: TrainCfg, seed: int, device: str | torch.device = "cuda") -> dict:
    """Encoder weights from ``seed`` (as flax initializes them), BN buffers
    at mean 0 / var 1, a fresh Adam and step 0, on ``device`` (default the
    GPU; raises without one)."""
    encoder = make_encoder(cfg.encoder, device=device, seed=seed, train=True)
    return {
        "encoder": encoder,
        "optimizer": make_optimizer(cfg.optimizer, encoder.parameters()),
        "step": 0,
    }


def _on_device(views: Mapping[str, Any], device: torch.device,
               depth: bool = False) -> dict[str, torch.Tensor]:
    """The view tensors on ``device``, with the sensor ``depth`` (when the
    batch has it) if ``depth``."""
    keys = (*_VIEW_KEYS, "depth") if depth else _VIEW_KEYS
    return {k: torch.as_tensor(views[k]).to(device, torch.float32) for k in keys if k in views}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(
    cfg: TrainCfg, lpips: torch.nn.Module | None = None
) -> Callable[..., tuple[dict, dict]]:
    """``train_step(state, batch, timings=None) -> (state, metrics)``.

    ``lpips``: None (no LPIPS term, as in the JAX package) or an ``LPIPS``
    module on the state's device (``lpips.make_lpips``).
    ``metrics`` holds 0-d tensors (no host sync): ``loss``, ``psnr``,
    ``gs_ratio``, ``num_gaussians``, ``dropped_instances`` and one
    ``loss_<part>`` per loss term.  ``timings``, if given, collects per
    step "forward_s", "backward_s" and "optimizer_s" (host clock around
    synchronized device work; the syncs cost the step its overlap)."""
    schedule = make_schedule(cfg.optimizer)
    dc = cfg.loss.depth
    depth_on = dc is not None and bool(
        dc.ms_gradient_weight or dc.scale_invariant_weight or dc.normals_weight
        or dc.mv_consistency_weight
    )

    def train_step(state: dict, batch: Mapping[str, Any],
                   timings: dict[str, list[float]] | None = None) -> tuple[dict, dict]:
        encoder, optimizer, step = state["encoder"], state["optimizer"], state["step"]
        params = list(encoder.parameters())
        device = params[0].device
        context = _on_device(batch["context"], device)
        target = _on_device(batch["target"], device, depth=depth_on)
        h, w = target["image"].shape[2:4]

        if timings is not None:
            _sync(device)
        t0 = time.perf_counter()
        results = encoder(context)
        output = render_views(
            cfg.decoder, results["gaussians"], target["extrinsics"],
            target["intrinsics"], target["near"], target["far"], (h, w),
        )
        depth_ctx = None
        if depth_on:
            depth_ctx = {
                "rendered_depth": output.depth,
                "gt_depth": target.get("depth"),
                "intrinsics": target["intrinsics"],
                "enc_depth": results.get("depth_s-1"),
                "ctx_extrinsics": context["extrinsics"],
                "ctx_intrinsics": context["intrinsics"],
            }
        loss, parts = total_loss(cfg.loss, output.color, target["image"], step, lpips,
                                 depth_ctx=depth_ctx)
        if timings is not None:
            _sync(device)
        t1 = time.perf_counter()

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if timings is not None:
            _sync(device)
        t2 = time.perf_counter()

        # optax updates every leaf; a parameter the loss does not reach
        # gets a zero gradient (Adam then leaves it where it is).
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_grad_global_norm([p.grad for p in params], cfg.optimizer.gradient_clip_val)
        for group in optimizer.param_groups:
            group["lr"] = schedule(step)
        optimizer.step()
        if timings is not None:
            _sync(device)
            t3 = time.perf_counter()
            timings.setdefault("forward_s", []).append(t1 - t0)
            timings.setdefault("backward_s", []).append(t2 - t1)
            timings.setdefault("optimizer_s", []).append(t3 - t2)

        with torch.no_grad():
            metrics = {
                "loss": loss.detach(),
                "psnr": compute_psnr(
                    target["image"].reshape(-1, h, w, 3), output.color.reshape(-1, h, w, 3)
                ).mean(),
                "gs_ratio": results["gs_ratio"].float().mean(),
                "num_gaussians": results["num_gaussians"].float().mean(),
                "dropped_instances": output.dropped.sum(),
                **{f"loss_{k}": v.detach() for k, v in parts.items()},
            }
        return {**state, "step": step + 1}, metrics

    return train_step


def fit(
    cfg: TrainCfg,
    state: dict,
    batches: Iterator[dict],
    max_steps: int,
    lpips: torch.nn.Module | None = None,
    log_fn: Callable[[int, dict], None] | None = None,
    checkpoint_fn: Callable[[int, dict], None] | None = None,
    checkpoint_every: int = 10_000,
    val_fn: Callable[[int, dict], None] | None = None,
    val_every: int = 5_000,
    timings: dict[str, list[float]] | None = None,
) -> dict:
    """Host training loop (the Lightning-fit equivalent).

    Metrics are logged one interval late, as in the JAX package: by the
    next log point the values are on the host side of the pipeline, so
    reading them does not stall the device.  ``timings`` is passed to
    every step (see ``make_train_step``)."""
    train_step = make_train_step(cfg, lpips)
    step = int(state["step"])
    pending: tuple[int, dict, float] | None = None  # (step, metrics, seconds)

    def emit(entry):
        p_step, refs, dt = entry
        vals = {k: float(v) for k, v in refs.items()}
        vals["steps_per_s"] = cfg.log_every / max(dt, 1e-9)
        if vals.get("dropped_instances", 0) > 0:
            print(
                f"WARNING step {p_step}: rasterizer dropped "
                f"{int(vals['dropped_instances'])} instances "
                "(capacity/MAX_CHUNKS overflow) — raise "
                "decoder.capacity_factor",
                flush=True,
            )
        log_fn(p_step, vals)

    t0 = time.time()
    for batch in batches:
        if step >= max_steps:
            break
        state, metrics = train_step(state, batch, timings=timings)
        if log_fn is not None and step % cfg.log_every == 0:
            if pending is not None:
                emit(pending)
            pending = (step, metrics, time.time() - t0)
            t0 = time.time()
        elif pending is not None and step - pending[0] >= 64:
            # Backpressure: the host runs at most ~64 steps ahead.
            emit(pending)
            pending = None
        sync = (
            (checkpoint_fn is not None and step % checkpoint_every == 0)
            or (val_fn is not None and step % val_every == 0)
        ) and step > 0
        if sync and pending is not None:
            emit(pending)  # keep log order ahead of val/ckpt output
            pending = None
        if checkpoint_fn is not None and step > 0 and step % checkpoint_every == 0:
            checkpoint_fn(step, state)
        if val_fn is not None and step > 0 and step % val_every == 0:
            val_fn(step, state)
        step += 1
    if pending is not None and log_fn is not None:
        emit(pending)
    return state
