"""Scaling benchmark of the sharded render: rays/s of one value-and-
gradient step of ``rasterize_sharded`` at one device and at the launch's
world size.

Port of ``freesplat_tpu/parallel/scaling_bench.py``.  Under a launch of N
processes (``torchrun --nproc_per_node N -m
freesplat_tpu_torch.parallel.scaling_bench``) it times rank 0 alone (no
group) and then all N ranks; alone it times one device.  One JSON line
per configuration, and the scaling efficiency when there are two.  Each
step renders a 384x512 view of 196,608 Gaussians and must drop no
instance: a slab budget that cut instances at N ranks but not at one
would flatter the efficiency.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops.gaussians import build_covariance
from ..utils.device import resolve_device
from .distributed import group_rank, make_group, maybe_initialize_distributed, rank_device
from .sharded_render import rasterize_sharded


def build_scene(n: int, seed: int = 0) -> tuple[np.ndarray, ...]:
    """JAX's scene: n Gaussians in a 6 x 6 x 9.2 box in front of the
    camera, scales 0.005-0.03, SH degree 2 (numpy, float32)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform([-3, -3, 0.8], [3, 3, 10], size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.005, 0.03, size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    cov = build_covariance(torch.from_numpy(scales), torch.from_numpy(q)).numpy()
    harm = (rng.normal(size=(n, 3, 9)) * 0.3).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, size=n).astype(np.float32)
    return means, cov, harm, opac


def bench_group(
    group,
    image_shape: tuple[int, int] = (384, 512),
    n_gaussians: int = 196608,
    reps: int = 8,
    device: str | torch.device = "cuda",
) -> dict:
    """ms and rays/s of one value-and-gradient step of ``rasterize_sharded``
    over ``group``'s ranks (None: this process alone), each rank holding
    its share of the scene; host clock around ``reps`` synchronized steps
    after one warm step (the collectives are inside the step).  Raises if
    any slab dropped an instance."""
    rank, world = group_rank(group)
    h, w = image_shape
    share = slice(rank * n_gaussians // world, (rank + 1) * n_gaussians // world)
    means, cov, harm, opac = (torch.from_numpy(a[share]).to(device)
                              for a in build_scene(n_gaussians))
    extr = torch.eye(4, device=device)
    intr = torch.tensor([[1.07, 0, 0.5], [0, 1.42, 0.5], [0, 0, 1]], device=device)
    bg = torch.zeros(3, device=device)
    params = [t.requires_grad_() for t in (means, cov, harm, opac)]

    def step():
        color, _, _, stats = rasterize_sharded(
            *params, extr, intr, image_shape, bg, 2, group=group,
            capacity=2 * n_gaussians, return_stats=True)
        loss = (color ** 2).mean()
        grads = torch.autograd.grad(loss, params)
        return loss, grads, stats["dropped"]

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    _, _, dropped = step()
    if int(dropped):
        raise AssertionError(f"{int(dropped)} instances dropped at {world} devices: raise "
                             "per_device_capacity; the timing would not be comparable")
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    sync()
    dt = (time.perf_counter() - t0) / reps
    return {"devices": world, "rays_per_s": h * w / dt, "ms_per_step": dt * 1e3}


def main(argv: list[str] | None = None, device: str | torch.device = "cuda") -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--gaussians", type=int, default=196608)
    p.add_argument("--reps", type=int, default=8)
    args = p.parse_args(argv)
    device = resolve_device(device)
    if maybe_initialize_distributed(device):
        device = rank_device(device)
    group = make_group("auto")
    rank, world = group_rank(group)
    shape = (args.height, args.width)
    results = []
    for g in ([None, group] if world > 1 else [group]):
        if g is None and rank != 0:
            result = None
        else:
            result = bench_group(g, shape, args.gaussians, args.reps, device)
        if group is not None:
            dist.barrier(group=group)
        if rank == 0:
            results.append(result)
            print(json.dumps(result), flush=True)
    if len(results) == 2:
        eff = results[1]["rays_per_s"] / (results[0]["rays_per_s"] * results[1]["devices"])
        print(json.dumps({"scaling_efficiency": eff}), flush=True)
    return results


if __name__ == "__main__":
    main()
