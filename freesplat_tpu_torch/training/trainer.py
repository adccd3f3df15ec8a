"""Training runtime: the train step and its host loop.

Port of ``freesplat_tpu/training/trainer.py``: one ``train_step``
(encoder -> render -> loss -> backward -> global-norm clip -> Adam at the
scheduled learning rate) and ``fit``, the host loop with the same
callbacks, logging interval and dropped-instance warning.  Data
parallelism (JAX's mesh) takes a process group: each rank steps on its
own batch, and the gradients are averaged over the ranks before the clip
(``make_train_step``).

The state is a dict: ``encoder`` (the module in ``train()`` mode; its
parameters and BN running buffers are the JAX state's ``params`` and
``batch_stats``), ``optimizer`` (``torch.optim.Adam``, the ``opt_state``)
and ``step`` (a Python int).  A step updates the encoder and the
optimizer in place and returns the state with the step advanced.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Mapping

import torch
import torch.distributed as dist

from ..models.backbone import synced_batch_norm
from ..models.decoder import DecoderCfg, render_views
from ..models.encoder import EncoderFreeSplatCfg, make_encoder
from ..parallel.distributed import group_rank
from ..utils.profiling import count, host_value, span, timed, upload
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
    return {k: upload(views[k], device, "step.upload") for k in keys if k in views}


# ``timings=``'s keys: (first span, last span) of each phase.
_STEP_TIMINGS = {
    "forward_s": ("step.forward", "loss"),
    "backward_s": ("step.backward", "step.backward"),
    "optimizer_s": ("step.optimizer", "step.optimizer"),
}


@contextlib.contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """Inside, cuDNN runs only its deterministic algorithms and picks none
    by timing; the flags are restored on exit.  With it, two runs of the
    train step from one seed take the same steps, bit for bit: the
    gathers' gradients already sum in a fixed order (``ops/gather.py``)."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def make_train_step(
    cfg: TrainCfg, lpips: torch.nn.Module | None = None, group=None,
) -> Callable[..., tuple[dict, dict]]:
    """``train_step(state, batch, timings=None) -> (state, metrics)``.

    ``group``: None (one process) or a process group of data-parallel
    ranks, each stepping on its own batch (the global batch is their
    concatenation, as under JAX's mesh).  Then batch-statistics BN
    normalizes over the global batch (``models/backbone.py::BatchNorm``),
    one all-reduce (SUM, then / world) of the flattened gradients follows
    ``loss.backward()`` and precedes the clip, which so sees the global
    gradient (JAX's ``psum``), and the metrics are all-reduced: every
    metric averaged over the ranks but ``dropped_instances``, summed.
    Every rank then takes the same Adam step from the same state.  Not
    ``DistributedDataParallel``: its bucketed all-reduce changes the
    gradient sums' order, and its buffer broadcast from rank 0 would
    overwrite the BN running buffers that the global statistics update
    alike on every rank.

    ``lpips``: None (no LPIPS term, as in the JAX package) or an ``LPIPS``
    module on the state's device (``lpips.make_lpips``).
    ``metrics`` holds 0-d tensors (no host sync): ``loss``, ``psnr``,
    ``gs_ratio``, ``num_gaussians``, ``dropped_instances`` and one
    ``loss_<part>`` per loss term.  ``timings``, if given, collects per
    step "forward_s", "backward_s" and "optimizer_s" (host clock around
    synchronized device work; the syncs cost the step its overlap): the
    view ``utils/profiling.py::timed`` takes of the spans ``step.forward``
    to ``loss``, ``step.backward`` and ``step.optimizer``.  The spans
    (and ``step.upload``, ``encoder``, the renders') go to the active
    recorder, with the counter ``dropped_instances`` every step."""
    schedule = make_schedule(cfg.optimizer)
    world = group_rank(group)[1]
    dc = cfg.loss.depth
    depth_on = dc is not None and bool(
        dc.ms_gradient_weight or dc.scale_invariant_weight or dc.normals_weight
        or dc.mv_consistency_weight
    )

    def train_step(state: dict, batch: Mapping[str, Any],
                   timings: dict[str, list[float]] | None = None) -> tuple[dict, dict]:
        with timed(timings, _STEP_TIMINGS):
            return _step(state, batch)

    def _step(state, batch):
        encoder, optimizer, step = state["encoder"], state["optimizer"], state["step"]
        params = list(encoder.parameters())
        device = params[0].device
        with span("step.upload"):
            context = _on_device(batch["context"], device)
            target = _on_device(batch["target"], device, depth=depth_on)
        h, w = target["image"].shape[2:4]

        with span("step.forward"):
            with span("encoder"), synced_batch_norm(encoder, group):
                results = encoder(context)
            output = render_views(
                cfg.decoder, results["gaussians"], target["extrinsics"],
                target["intrinsics"], target["near"], target["far"], (h, w),
            )
        with span("loss"):
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

        with span("step.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()

        with span("step.optimizer"):
            # optax updates every leaf; a parameter the loss does not reach
            # gets a zero gradient (Adam then leaves it where it is).
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if group is not None:
                _all_reduce_mean([p.grad for p in params], group, world)
            clip_grad_global_norm([p.grad for p in params], cfg.optimizer.gradient_clip_val)
            for param_group in optimizer.param_groups:
                param_group["lr"] = schedule(step)
            optimizer.step()

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
            if group is not None:
                metrics = _reduce_metrics(metrics, group, world)
        count("dropped_instances", metrics["dropped_instances"])
        return {**state, "step": step + 1}, metrics

    return train_step


def _all_reduce_mean(grads: list[torch.Tensor], group, world: int) -> None:
    """In place: each gradient summed over the ranks and divided by
    ``world``, in one all-reduce of the flattened vector."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _reduce_metrics(metrics: dict, group, world: int) -> dict:
    """The ranks' metrics in one all-reduce: ``dropped_instances`` summed,
    the others averaged (float64 on the wire, each back in its dtype)."""
    keys = list(metrics)  # the same order on every rank
    flat = torch.stack([metrics[k].double() for k in keys])
    dist.all_reduce(flat, group=group)
    return {k: (v if k == "dropped_instances" else v / world).to(metrics[k].dtype)
            for k, v in zip(keys, flat)}


@deterministic_cudnn()
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
    group=None,
) -> dict:
    """Host training loop (the Lightning-fit equivalent).

    Metrics are logged one interval late, as in the JAX package: by the
    next log point the values are on the host side of the pipeline, so
    reading them does not stall the device.  ``timings`` is passed to
    every step (see ``make_train_step``).  The loop, its validation and
    checkpoints included, runs under ``deterministic_cudnn``.  Each step
    is a ``step`` span with the step as its unit; logging, checkpoints
    and validation are ``fit.log``, ``fit.checkpoint`` and
    ``fit.validate`` spans.  ``group``:
    data-parallel ranks (``make_train_step``); every rank runs the loop,
    and the callbacks decide what each rank does (``main.train``: rank 0
    logs, checkpoints and validates)."""
    train_step = (make_train_step(cfg, lpips) if group is None
                  else make_train_step(cfg, lpips, group=group))
    step = int(state["step"])
    pending: tuple[int, dict, float] | None = None  # (step, metrics, seconds)

    def emit(entry):
        p_step, refs, dt = entry
        vals = {k: float(host_value(v, "fit.emit")) for k, v in refs.items()}
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
        with span("step", unit=step):
            state, metrics = train_step(state, batch, timings=timings)
        if log_fn is not None and step % cfg.log_every == 0:
            if pending is not None:
                with span("fit.log"):
                    emit(pending)
            pending = (step, metrics, time.time() - t0)
            t0 = time.time()
        elif pending is not None and step - pending[0] >= 64:
            # Backpressure: the host runs at most ~64 steps ahead.
            with span("fit.log"):
                emit(pending)
            pending = None
        sync = (
            (checkpoint_fn is not None and step % checkpoint_every == 0)
            or (val_fn is not None and step % val_every == 0)
        ) and step > 0
        if sync and pending is not None:
            with span("fit.log"):
                emit(pending)  # keep log order ahead of val/ckpt output
            pending = None
        if checkpoint_fn is not None and step > 0 and step % checkpoint_every == 0:
            with span("fit.checkpoint"):
                checkpoint_fn(step, state)
        if val_fn is not None and step > 0 and step % val_every == 0:
            with span("fit.validate"):
                val_fn(step, state)
        step += 1
    if pending is not None and log_fn is not None:
        with span("fit.log"):
            emit(pending)
    return state
