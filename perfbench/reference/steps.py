"""The reference's train step and scene evaluation, in plain PyTorch.

Train step: encode the context -> render every target view -> MSE +
weighted LPIPS -> backward -> clip the global gradient norm (scale by
max / |g| only when |g| > max) -> Adam (betas 0.9 / 0.999, eps 1e-8) at
the one-cycle learning rate of optax's ``cosine_onecycle_schedule``
(warm-up ``warm_up_steps`` from lr / 25 to lr, then cosine down to
lr / 25 / 1e4 at ``max_steps``).  Scene: encode -> render -> PSNR, SSIM
and LPIPS over the target views.
"""
from __future__ import annotations

import contextlib
import math

import torch

from .render import psnr, render_view, ssim


def learning_rate(o: dict, step: int) -> float:
    lr, steps = float(o["optimizer.lr"]), int(o["optimizer.max_steps"])
    bounds = (0, int(max(int(o["optimizer.warm_up_steps"]), 1) / max(steps, 1) * steps), steps)
    values = (lr / 25.0, lr, lr / 25.0 / 1e4)
    for i in range(2):
        if bounds[i] <= step < bounds[i + 1]:
            frac = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (math.cos(math.pi * frac) + 1)
    return values[2] if step >= bounds[2] else 0.0


def render_targets(encoder, gaussians, target, image_shape):
    near = target["near"][0]
    colors = [render_view(gaussians, target["extrinsics"][0, i], target["intrinsics"][0, i],
                          near[i], image_shape, encoder.sizes.sh_degree)[0]
              for i in range(target["image"].shape[1])]
    return torch.stack(colors)  # (v, h, w, 3)


def loss_of(encoder, lpips, o: dict, context, target):
    image_shape = tuple(target["image"].shape[2:4])
    color = render_targets(encoder, encoder.encode(context), target, image_shape)
    truth = target["image"][0]
    loss = float(o["loss.mse.weight"]) * ((color - truth) ** 2).mean()
    return loss + float(o["loss.lpips.weight"]) * lpips(color, truth).mean()


class Adam:
    """Plain Adam over a list of parameters, bias-corrected."""

    def __init__(self, params, betas=(0.9, 0.999), eps=1e-8):
        self.params = params
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr: float):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))


def train_steps(encoder, lpips, o: dict, batches, first_step: int = 0, flops=None):
    """Train ``encoder`` on ``batches`` (on the device), one step each.
    Returns {"loss": [per step], "grad_norms": per-leaf norms of the first
    step's clipped gradient, "change_norms": per-leaf norms of the
    parameters' change over all the steps}.  ``flops``: a context manager
    entered around the first step (a FLOP counter)."""
    names = [k for k, _ in encoder.named_parameters()]
    params = [p for _, p in encoder.named_parameters()]
    start = [p.detach().clone() for p in params]
    adam = Adam(params)
    clip = float(o["optimizer.gradient_clip_val"])
    out = {"loss": []}
    for i, batch in enumerate(batches):
        for p in params:
            p.grad = None
        with (flops if (flops is not None and i == 0) else contextlib.nullcontext()):
            loss = loss_of(encoder, lpips, o, batch["context"], batch["target"])
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            scale = clip / norm if float(norm) > clip else 1.0
            grads = [g * scale for g in grads]
        if i == 0:
            out["grad_norms"] = dict(zip(names, (float(g.norm()) for g in grads)))
        adam.step(grads, learning_rate(o, first_step + i))
        out["loss"].append(float(loss.detach()))
    out["change_norms"] = {n: float((p.detach() - s).norm())
                           for n, p, s in zip(names, params, start)}
    return out


@torch.no_grad()
def eval_scene(encoder, lpips, batch, view_chunk: int | None):
    """(colors (v, h, w, 3), {"psnr", "ssim", "lpips", "num_gaussians"})."""
    target = batch["target"]
    gaussians = encoder.encode(batch["context"], view_chunk)
    color = render_targets(encoder, gaussians, target, tuple(target["image"].shape[2:4]))
    truth = target["image"][0]
    return color, {
        "psnr": float(psnr(truth, color).mean()),
        "ssim": float(ssim(truth, color).mean()),
        "lpips": float(lpips(color, truth).mean()),
        "num_gaussians": float(gaussians["num_gaussians"]),
    }
