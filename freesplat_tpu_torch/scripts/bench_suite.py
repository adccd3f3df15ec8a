"""Benchmark suite over the BASELINE configurations (synthetic inputs).

Port of ``freesplat_tpu/scripts/bench_suite.py``.  Prints one JSON line
per benchmark, ``{"metric", "value", "unit"}`` under the JAX script's
metric names:
  rasterize fwd / fwd+bwd (2-view Gaussian budget)
  encoder inference (ScanNet 2-view shapes)
  PTF forward (2 views)
  full train step (ScanNet 2-view / 3-view)

Run (the GPU unless ``--device cpu``):
  python -m freesplat_tpu_torch.scripts.bench_suite [raster] [encoder]
      [ptf] [train2] [train3]
(no stage = raster only).  Timings are ``utils/timing.bench``'s: CUDA
events around the calls and a device synchronize.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

STAGES = ("raster", "encoder", "ptf", "train2", "train3")
INTRINSICS = [[1.07, 0, 0.5], [0, 1.42, 0.5], [0, 0, 1]]


def _pipelined(fn, *args, reps: int = 8, device="cuda") -> float:
    from ..utils.timing import bench

    return bench(fn, [args], n=reps, device=device)


def _emit(metric: str, value: float, unit: str) -> None:
    print(json.dumps({"metric": metric, "value": round(value, 2), "unit": unit}),
          flush=True)


def _scene(n, seed=0, device="cuda"):
    from ..ops.gaussians import build_covariance

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    means = t(rng.uniform([-3, -3, 0.8], [3, 3, 10], size=(n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cov = build_covariance(t(rng.uniform(0.005, 0.03, size=(n, 3))), t(q))
    harm = t(rng.normal(size=(n, 3, 9)) * 0.3)
    opac = t(rng.uniform(0.3, 1.0, size=n))
    return means, cov, harm, opac


def _context(v, h, w, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    intr = np.zeros((1, v, 3, 3), np.float32)
    intr[..., 0, 0] = 1.07
    intr[..., 1, 1] = 1.42
    intr[..., 0, 2] = intr[..., 1, 2] = 0.5
    intr[..., 2, 2] = 1.0
    extr = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    for vi in range(v):
        extr[:, vi, 0, 3] = 0.2 * vi
    return {
        "image": torch.as_tensor(rng.uniform(size=(1, v, h, w, 3)).astype(np.float32),
                                 device=device),
        "intrinsics": torch.as_tensor(intr, device=device),
        "extrinsics": torch.as_tensor(extr, device=device),
        "near": torch.full((1, v), 0.5, device=device),
        "far": torch.full((1, v), 15.0, device=device),
    }


def bench_raster(device="cuda", h: int = 384, w: int = 512, n: int = 196608,
                 reps: int = 8) -> None:
    from ..ops.rasterizer import rasterize

    means, cov, harm, opac = _scene(n, device=device)
    extr = torch.eye(4, device=device)
    intr = torch.tensor(INTRINSICS, device=device)
    bg = torch.zeros(3, device=device)

    @torch.no_grad()
    def f(*a):
        return rasterize(*a, extr, intr, (h, w), bg, 2, 2 * n)

    dt = _pipelined(f, means, cov, harm, opac, reps=reps, device=device)
    _emit("raster_fwd", h * w / dt, "rays/s")

    def g(*a):
        a = [x.detach().requires_grad_() for x in a]
        loss = torch.mean(rasterize(*a, extr, intr, (h, w), bg, 2, 2 * n)[0] ** 2)
        return loss, torch.autograd.grad(loss, a)

    dt = _pipelined(g, means, cov, harm, opac, reps=reps, device=device)
    _emit("raster_fwd_bwd", h * w / dt, "rays/s")


def bench_encoder(device="cuda", h: int = 384, w: int = 512, depth: int = 128,
                  reps: int = 4) -> None:
    from ..models.adapter import GaussianAdapterCfg
    from ..models.encoder import EncoderFreeSplatCfg, make_encoder

    cfg = EncoderFreeSplatCfg(
        num_depth_candidates=depth, adapter=GaussianAdapterCfg(sh_degree=2),
        train_bn=False,
    )
    ctx = _context(2, h, w, device=device)
    enc = make_encoder(cfg, device=device, seed=0)

    @torch.no_grad()
    def f(c):
        return enc(c)["gaussians"].means

    dt = _pipelined(f, ctx, reps=reps, device=device)
    _emit("encoder_fwd_2view", dt * 1e3, "ms/scene")


def bench_train(views: int, device="cuda", h: int = 384, w: int = 512, depth: int = 128,
                reps: int = 4) -> None:
    from ..config.config import LossCfg, LossMseCfg, OptimizerCfg
    from ..models.adapter import GaussianAdapterCfg
    from ..models.decoder import DecoderCfg
    from ..models.encoder import EncoderFreeSplatCfg
    from ..training.trainer import TrainCfg, init_state, make_train_step

    cfg = TrainCfg(
        encoder=EncoderFreeSplatCfg(
            num_depth_candidates=depth, num_views=views,
            adapter=GaussianAdapterCfg(sh_degree=2),
        ),
        decoder=DecoderCfg(sh_degree=2, capacity_factor=2),
        loss=LossCfg(mse=LossMseCfg(1.0), lpips=None),
        optimizer=OptimizerCfg(),
    )
    batch = {"context": _context(views, h, w, device=device),
             "target": _context(1, h, w, seed=1, device=device)}
    state = init_state(cfg, seed=0, device=device)
    step = make_train_step(cfg)

    def one(state):
        s, _ = step(state, batch)
        return s

    dt = _pipelined(one, state, reps=reps, device=device)
    _emit(f"train_step_{views}view", dt * 1e3, "ms/step")


def bench_ptf(views: int = 2, device="cuda", h: int = 384, w: int = 512,
              reps: int = 4) -> None:
    from ..models.encoder import init_like_flax
    from ..models.networks import GRU
    from ..models.ptf import fuse_views

    hw = h * w
    c = 64
    rng = np.random.default_rng(0)
    gru = init_like_flax(GRU(hidden_channel=c), 0).to(device)
    extr = np.tile(np.eye(4, dtype=np.float32), (views, 1, 1))
    extr[:, 0, 3] = 0.2 * np.arange(views)
    intr = np.tile(np.array(INTRINSICS, np.float32), (views, 1, 1))
    extr_t, intr_t = (torch.as_tensor(x, device=device) for x in (extr, intr))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    args = (
        t(rng.standard_normal((views, hw, c))),
        t(rng.uniform(-2, 2, (views, hw, 3))),
        t(rng.uniform(0, 1, (views, hw, 1))),
        t(rng.uniform(0, 1, (views, hw, 1))),
        t(rng.uniform(1, 10, (views, hw))),
    )

    @torch.no_grad()
    def f(ft, co, de, wt, dp):
        return fuse_views(ft, co, de, wt, dp, extr_t, intr_t, (h, w), gru).feat

    dt = _pipelined(f, *args, reps=reps, device=device)
    _emit(f"ptf_fwd_{views}view", dt * 1e3, "ms")


def main(argv=None, device: str | None = None) -> None:
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("stages", nargs="*", choices=STAGES)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(device or args.device)
    which = set(args.stages) or {"raster"}
    if "raster" in which:
        bench_raster(device)
    if "encoder" in which:
        bench_encoder(device)
    if "ptf" in which:
        bench_ptf(2, device)
    if "train2" in which:
        bench_train(2, device)
    if "train3" in which:
        bench_train(3, device)


if __name__ == "__main__":
    main()
