"""The ``fit`` entry: FreeSplat training as ``main.train`` runs it.

Set-up draws the weights and the scene pool from the seed, builds the
train state with the port's ``init_state`` and loads the weights into it.
Then one ``fit`` call, with ``log_every`` from the mix, takes its batches
from one feed: first ``warmup_units`` steps (set-up), the first three of
which the reference follows, then, after a synchronize, the window's
steps until the deadline; the window ends at a synchronize after the last
step.  A traced run makes that call with ``profile_units`` steps under the
profiler in the window's place, then a second call on the same state for
a window's length with ``timings=``.

Read on the way, without a synchronize in the steps: a forward hook on
the LPIPS module that the run hands to ``fit`` keeps each step's LPIPS
distances, and for the compared steps the program's rendered views and
targets as the loss receives them; the feed reads Adam's first moment
after step 0 and each leaf's change after step 2, before the window.

Compared with the reference (``reference/steps.py``) once the window has
closed: the loss of each of the first three steps (the configuration's
MSE + LPIPS terms over the views and distances the hook kept), and step
0's loss as ``fit`` logged it; the first step's clipped gradient by leaf
(Adam's first moment over 1 - beta1); and each leaf's change over the
three steps.  The leaves whose reference gradient is under a thousandth
of the median leaf's are left out of the change.  A step fails when its
LPIPS distances are not finite, or, at the steps ``fit`` logs, when its
loss is not finite or it dropped rasterizer instances: the program
reports drops at logged steps only.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from ..harness import Cell, Check, Run
from ..reference.render import render_view
from ..reference.steps import train_steps
from ..roofline import flops as flop_count
from ..roofline import raster
from ..scenes import make_pool, to_device
from ..trace import Stretch
from . import common

COMPARED_STEPS = 3


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    from freesplat_tpu_torch.training.trainer import TrainCfg, fit, init_state

    o, tr = cell.config["overrides"], cell.traffic
    warm = tr["warmup_units"]
    if warm < COMPARED_STEPS:
        raise ValueError(f"warmup_units must be at least {COMPARED_STEPS}")
    cfg = common.port_config(cell)
    train_cfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                         optimizer=cfg.optimizer, log_every=tr["log_every"])
    result = Run(entry="fit")
    result.mark("start and imports")
    enc_sd, lp_sd = common.draw_weights(cell, seed, device)
    result.mark("weights")
    pool = make_pool(tr, o, seed, device)
    result.mark("scene pool")
    state = init_state(train_cfg, seed=cfg.seed, device=device)
    state["encoder"].load_state_dict(enc_sd, strict=True)
    lpips = common.port_lpips(lp_sd, device)
    del enc_sd, lp_sd
    result.mark("program state")
    encoder, optimizer = state["encoder"], state["optimizer"]
    names = [n for n, _ in encoder.named_parameters()]
    params = [p for _, p in encoder.named_parameters()]
    beta1 = optimizer.param_groups[0]["betas"][0]
    theta0 = [p.detach().clone() for p in params]
    readings: dict = {}
    distances: list[torch.Tensor] = []  # each step's LPIPS distances, step by step
    losses: list[torch.Tensor] = []  # the compared steps' losses, from the hook
    w_mse, w_lpips = float(o["loss.mse.weight"]), float(o["loss.lpips.weight"])

    def hook(module, args, out):
        distances.append(out.detach())
        if len(losses) < COMPARED_STEPS:
            pred, target = (a.detach() for a in args)
            losses.append(w_mse * ((pred - target) ** 2).mean() + w_lpips * out.detach().mean())

    lpips.register_forward_hook(hook)
    log: list[tuple[int, dict]] = []
    snapshot: dict = {}

    def read_change():
        if "change" not in readings:  # before step 3 runs
            readings["change"] = torch.stack([(p.detach() - t).norm()
                                              for p, t in zip(params, theta0)])
            theta0.clear()

    def on_unit(k):
        if k == 1:  # after step 0: Adam's first moment is (1 - beta1) g
            readings["grad"] = torch.stack(
                [optimizer.state[p]["exp_avg"].norm() if "exp_avg" in optimizer.state[p]
                 else p.new_zeros(()) for p in params]) / (1 - beta1)
        elif k == COMPARED_STEPS:
            read_change()

    def on_start(k):
        read_change()
        common.sync(device)
        result.mark("warm-up steps")
        result.peak_process_bytes = common.peak_bytes(device)
        common.reset_peak(device)
        if trace:
            snapshot.update({"unit": k, "state": {n: v.detach().clone()
                                                  for n, v in encoder.state_dict().items()}})
            stretch.begin()

    stretch = Stretch() if trace else None
    feed = common.Feed(pool, 0, warm, None if trace else seconds, device,
                       limit=tr["profile_units"] if trace else None,
                       on_start=on_start, on_unit=on_unit)
    state = fit(train_cfg, state, iter(feed), 10**12, lpips=lpips,
                log_fn=lambda s, v: log.append((s, v)))
    if trace:
        stretch.end()
        result.setup_s = feed.start - t_start
        result.profile = stretch.reduce()
        result.profile["units"] = feed.handed
        result.profile["host_s"] = stretch.host_s
        result.notes.append(f"profiled stretch: {1000 * stretch.host_s / feed.handed!r} ms a unit "
                            f"over {feed.handed} units")
        result.timings = {}
        feed = common.Feed(pool, feed.units[-1] + 1, 0, seconds, device)
        state = fit(train_cfg, state, iter(feed), 10**12, lpips=lpips,
                    log_fn=lambda s, v: log.append((s, v)), timings=result.timings)
    common.sync(device)
    t_end = time.perf_counter()
    result.notes.append(common.unit_note(feed, t_end))
    if not trace:
        result.setup_s = feed.start - t_start
    result.notes.append(result.setup_note(t_start))
    if trace:
        result.profile["units_timed"] = feed.handed
    result.window_s = t_end - feed.start
    result.units = result.attempted = feed.handed
    result.peak_window_bytes = common.peak_bytes(device)
    result.peak_process_bytes = max(result.peak_process_bytes, result.peak_window_bytes)
    result.failed = _failed(feed.units, distances, dict(log), params)

    logged = dict(log)
    program = {
        "loss": [float(x) for x in losses],
        "logged_loss": logged[0]["loss"],
        "dropped": [v["dropped_instances"] for v in logged.values()],
        "grad_norms": dict(zip(names, readings["grad"].tolist())),
        "change_norms": dict(zip(names, readings["change"].tolist())),
    }
    del state, encoder, optimizer, params, lpips, readings, distances, losses
    common.free(device)

    # The reference: the same weights and the same first three batches.
    enc_sd, lp_sd = common.draw_weights(cell, seed, device)
    ref_enc, ref_lp = common.load_reference(cell, enc_sd, lp_sd, device)
    del enc_sd, lp_sd
    batches = [{k: to_device(pool[i][k], device) for k in ("context", "target")}
               for i in range(COMPARED_STEPS)]
    counter = flop_count.counter() if trace else None
    ref = train_steps(ref_enc, ref_lp, o, batches, flops=counter)
    if trace:
        result.model_flops_per_unit = flop_count.total(counter)
    result.checks = compare(program, ref, cell.workload["limits"])
    if trace:
        ref_enc.load_state_dict(snapshot["state"], strict=True)
        result.raster = _raster_work(ref_enc, pool[snapshot["unit"] % len(pool)], device)
    return result


def _failed(units: list[int], distances: list[torch.Tensor], logged: dict, params) -> int:
    """Window steps (``units``, numbered as ``fit`` numbers its steps) whose
    LPIPS distances are not finite, or, where logged, whose loss is not
    finite or that dropped instances; all of them if the weights end
    non-finite."""
    if not all(bool(torch.isfinite(p).all()) for p in params):
        return len(units)
    finite = torch.stack([torch.isfinite(distances[k]).all() for k in units]).tolist()
    bad = 0
    for k, ok in zip(units, finite):
        v = logged.get(k)
        bad += (not ok) or (v is not None and (not math.isfinite(v["loss"])
                                               or v["dropped_instances"] > 0))
    return bad


def compare(program: dict, ref: dict, limits: dict) -> list[Check]:
    """The loss of each compared step and step 0's logged loss, the first
    clipped gradient's norm by leaf, and each moving leaf's change, as
    relative gaps (``common.worst_relative``); a logged step that dropped
    rasterizer instances fails."""
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    moving = [k for k in grads if grads[k] >= 1e-3 * med]
    pairs = list(zip(program["loss"], ref["loss"])) + [(program["logged_loss"], ref["loss"][0])]
    loss = max(abs(p - r) / abs(r) for p, r in pairs)
    if len(program["loss"]) < len(ref["loss"]):
        loss = float("inf")
    return [
        Check("loss_rel", loss, limits["loss_rel"]),
        Check("grad_rel", common.worst_relative(program["grad_norms"], grads), limits["grad_rel"]),
        Check("change_rel", common.worst_relative(program["change_norms"], ref["change_norms"],
                                                  moving), limits["change_rel"]),
        Check("dropped", float(sum(program["dropped"])), 0.0),
    ]


@torch.no_grad()
def _raster_work(ref_enc, batch, device) -> dict:
    """Operations and bytes of the rasterizer kernels over one step's views."""
    ctx, tgt = (to_device(batch[k], device) for k in ("context", "target"))
    gaussians = ref_enc.encode(ctx)
    image_shape = tuple(tgt["image"].shape[2:4])
    work = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    views = tgt["image"].shape[1]
    for i in range(views):
        counts = render_view(gaussians, tgt["extrinsics"][0, i], tgt["intrinsics"][0, i],
                             tgt["near"][0, i], image_shape, ref_enc.sizes.sh_degree,
                             count_pairs=True)[3]
        for kind, fn in (("fwd", raster.forward), ("bwd", raster.backward)):
            f, b = fn(counts)
            work[kind][0] += f
            work[kind][1] += b
    return {k: {"flops": f, "bytes": b, "launches": views} for k, (f, b) in work.items()}
