"""Device-fenced stage profiles at ScanNet 2-view shapes (384x512, D = 128).

Port of ``freesplat_tpu/scripts/profile_stages.py``.  Each stage times
its forward and its forward + backward with ``utils/timing.bench`` (CUDA
events around the calls, then a device synchronize) and prints
``<name>: <ms> ms`` under the JAX script's names.  Importing the module
runs nothing; ``main`` does the work.

Usage (the GPU unless ``--device cpu``):
  python -m freesplat_tpu_torch.scripts.profile_stages [stage ...]
stages: backbone cvenc dec ptf adapter raster train train_bf16
        raster_sub   (binning / instance rows / fwd kernel / bwd kernel
                      / scatter reduction sub-stages)
No stage runs every stage but ``train_bf16`` and ``raster_sub``.  Run it
alone on the card: another process on the same host moves the numbers.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

STAGES = ("backbone", "cvenc", "dec", "ptf", "adapter", "raster", "train", "train_bf16",
          "raster_sub")
DEFAULT_STAGES = ("backbone", "cvenc", "dec", "ptf", "adapter", "raster", "train")
INTRINSICS = [[1.07, 0, 0.5], [0, 1.42, 0.5], [0, 0, 1]]


@dataclass
class Shapes:
    """A stage's sizes (default the ScanNet 2-view ones) and device, and
    the numpy stream that draws its inputs."""

    v: int = 2
    h: int = 384
    w: int = 512
    depth: int = 128
    device: str | torch.device = "cuda"
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def rnd(self, *shape, scale: float = 1.0) -> torch.Tensor:
        return torch.as_tensor((self.rng.standard_normal(shape) * scale).astype(np.float32),
                               device=self.device)

    def uniform(self, lo, hi, shape) -> torch.Tensor:
        return torch.as_tensor(self.rng.uniform(lo, hi, shape).astype(np.float32),
                               device=self.device)

    def feat_shapes(self):
        """The backbone's five NHWC feature maps (1/2 .. 1/32 resolution)."""
        v, h, w = self.v, self.h, self.w
        return [(v, h // 2, w // 2, 24), (v, h // 4, w // 4, 48), (v, h // 8, w // 8, 64),
                (v, h // 16, w // 16, 160), (v, h // 32, w // 32, 256)]


def report(name: str, fn, args_list, device, n: int = 6) -> float:
    from ..utils.timing import bench

    dt = bench(fn, args_list, n=n, device=device)
    print(f"{name}: {dt * 1e3:.2f} ms", flush=True)
    return dt


def _grad(loss_fn, argnums):
    """``jax.grad(loss_fn, argnums)`` in torch: the gradients of the
    scalar ``loss_fn(*args)`` with respect to the tensors at ``argnums``
    (a list argument's tensors all count)."""
    def g(*args):
        args = list(args)
        leaves = []
        for i in argnums:
            if isinstance(args[i], (list, tuple)):
                args[i] = [x.detach().requires_grad_() for x in args[i]]
                leaves += args[i]
            else:
                args[i] = args[i].detach().requires_grad_()
                leaves.append(args[i])
        return torch.autograd.grad(loss_fn(*args), leaves)
    return g


def _params_grad(module, loss_fn):
    """The gradients of ``loss_fn(module(x))`` with respect to ``module``'s
    parameters."""
    params = [p for p in module.parameters() if p.requires_grad]

    def g(x):
        return torch.autograd.grad(loss_fn(module(x)), params, allow_unused=True)
    return g


def stage_backbone(s: Shapes) -> None:
    from ..models.backbone import EfficientNetV2S
    from ..models.encoder import init_like_flax

    for tbn in (False, True):
        m = init_like_flax(EfficientNetV2S(train_bn=tbn), 0).to(s.device).train(tbn)
        args = [(s.rnd(s.v, s.h, s.w, 3),) for _ in range(3)]
        report(f"backbone fwd bn={tbn}", torch.no_grad()(m), args, s.device)
        g = _params_grad(m, lambda ys: sum(y.sum() for y in ys))
        report(f"backbone fwd+bwd bn={tbn}", g, args, s.device)


def stage_cvenc(s: Shapes) -> None:
    from ..models.encoder import init_like_flax
    from ..models.networks import CVEncoder

    cve = init_like_flax(CVEncoder(in_ch=s.depth), 0).to(s.device)
    fs = s.feat_shapes()
    args = [(s.rnd(s.v, s.h // 4, s.w // 4, s.depth), [s.rnd(*x) for x in fs[1:]])
            for _ in range(3)]
    report("cv_encoder fwd", torch.no_grad()(cve), args, s.device)
    g = _grad(lambda c, f: sum(o.sum() for o in cve(c, f)), (0,))
    report("cv_encoder fwd+bwd", g, args, s.device)


def stage_dec(s: Shapes) -> None:
    from ..models.encoder import init_like_flax
    from ..models.networks import DepthDecoder

    chs = (24, 64, 128, 256, 384)
    dd = init_like_flax(DepthDecoder(in_chs=chs, num_output_channels=65,
                                     num_samples=s.depth), 0).to(s.device)

    def mk():
        return [s.rnd(s.v, s.h // 2 ** (i + 1), s.w // 2 ** (i + 1), c)
                for i, c in enumerate(chs)]

    args = [(mk(),) for _ in range(3)]
    report("depth_decoder fwd", torch.no_grad()(dd), args, s.device)
    g = _grad(lambda di: sum(o.sum() for o in dd(di).values()), (0,))
    report("depth_decoder fwd+bwd", g, args, s.device)


def stage_ptf(s: Shapes) -> None:
    from ..models.encoder import init_like_flax
    from ..models.networks import GRU
    from ..models.ptf import fuse_views

    gru = init_like_flax(GRU(hidden_channel=64), 0).to(s.device)
    hw = s.h * s.w
    extr = np.tile(np.eye(4, dtype=np.float32), (s.v, 1, 1))
    extr[1, 0, 3] = 0.2
    extr_t = torch.as_tensor(extr, device=s.device)
    intr_v = torch.as_tensor(np.tile(np.array(INTRINSICS, np.float32), (s.v, 1, 1)),
                             device=s.device)

    def mk():
        return (s.rnd(s.v, hw, 64), s.rnd(s.v, hw, 3), s.uniform(0, 1, (s.v, hw, 1)),
                s.uniform(0, 1, (s.v, hw, 1)), s.uniform(1, 10, (s.v, hw)))

    def fwd(ft, co, de, wt, dp):
        return fuse_views(ft, co, de, wt, dp, extr_t, intr_v, (s.h, s.w), gru)

    args = [mk() for _ in range(3)]
    report("ptf fwd", torch.no_grad()(fwd), args, s.device)

    def lfn(*a):
        st = fwd(*a)
        return st.feat.sum() + st.coords.sum() + st.density.sum()

    report("ptf fwd+bwd", _grad(lfn, (0, 1, 2)), args, s.device)


def stage_adapter(s: Shapes) -> None:
    from ..models.adapter import GaussianAdapterCfg, build_gaussians

    acfg = GaussianAdapterCfg(sh_degree=2)
    nslots = s.v * s.h * s.w
    intr = torch.tensor(INTRINSICS, device=s.device)
    rot = torch.eye(3, device=s.device).expand(nslots, 3, 3)

    def fwd(raw, dpt):
        return build_gaussians(acfg, raw, dpt, rot, intr, (s.h, s.w))

    args = [(s.rnd(nslots, acfg.d_in), s.uniform(1, 10, (nslots,))) for _ in range(3)]
    report("adapter fwd", torch.no_grad()(fwd), args, s.device)
    g = _grad(lambda raw, dpt: sum(x.sum() for x in fwd(raw, dpt).values()), (0, 1))
    report("adapter fwd+bwd", g, args, s.device)


def _raster_scene(s: Shapes, n: int):
    from ..ops.gaussians import build_covariance

    means = s.uniform([-3, -3, 0.8], [3, 3, 10], (n, 3))
    q = s.rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cov = build_covariance(s.uniform(0.005, 0.03, (n, 3)),
                           torch.as_tensor(q.astype(np.float32), device=s.device))
    return means, cov, s.rnd(n, 3, 9, scale=0.3), s.uniform(0.3, 1.0, n)


def _camera(s: Shapes):
    return (torch.eye(4, device=s.device), torch.tensor(INTRINSICS, device=s.device),
            torch.zeros(3, device=s.device))


def stage_raster(s: Shapes) -> None:
    from ..ops.rasterizer import rasterize

    n = 2 * s.h * s.w
    extr, intr, bg = _camera(s)

    def fwd(m, c, hh, o):
        return rasterize(m, c, hh, o, extr, intr, (s.h, s.w), bg, 2, capacity=2 * n)

    args = [_raster_scene(s, n) for _ in range(2)]
    report("raster fwd", torch.no_grad()(fwd), args, s.device)
    g = _grad(lambda *a: torch.mean(fwd(*a)[0] ** 2), (0, 1, 2, 3))
    report("raster fwd+bwd", g, args, s.device)


def stage_train(s: Shapes, variants) -> None:
    from ..config.config import LossCfg, LossMseCfg, OptimizerCfg
    from ..models.adapter import GaussianAdapterCfg
    from ..models.decoder import DecoderCfg
    from ..models.encoder import EncoderFreeSplatCfg
    from ..training.trainer import TrainCfg, init_state, make_train_step
    from .bench_suite import _context

    for tbn, cdt in variants:
        cfg = TrainCfg(
            encoder=EncoderFreeSplatCfg(num_depth_candidates=s.depth, num_views=2,
                                        adapter=GaussianAdapterCfg(sh_degree=2),
                                        train_bn=tbn, compute_dtype=cdt),
            decoder=DecoderCfg(sh_degree=2, capacity_factor=2),
            loss=LossCfg(mse=LossMseCfg(1.0), lpips=None),
            optimizer=OptimizerCfg(),
        )
        batch = {"context": _context(2, s.h, s.w, device=s.device),
                 "target": _context(1, s.h, s.w, seed=1, device=s.device)}
        state = init_state(cfg, seed=0, device=s.device)
        step = make_train_step(cfg)

        def run_step(img, state=state, step=step, batch=batch):
            bb = {**batch, "context": {**batch["context"], "image": img}}
            _, m = step(state, bb)
            return m["loss"]

        report(f"train_step bn={tbn} dtype={cdt}", run_step,
               [(s.uniform(0, 1, (1, 2, s.h, s.w, 3)),) for _ in range(3)], s.device, n=4)


def raster_substages(s: Shapes) -> None:
    from ..ops.rasterizer import (
        CHUNK, _tile_grid, bin_gaussians, build_instance_rows, composite_tiles,
        composite_tiles_fwd, rasterize,
    )
    from ..ops.rendering import preprocess_gaussians

    h, w = s.h, s.w
    n = 2 * h * w
    cap = -(-2 * n // CHUNK) * CHUNK
    extr, intr, bg = _camera(s)

    def rep(name, fn, args_list):
        report(name, fn, args_list, s.device, n=8)

    scenes = [_raster_scene(s, n) for _ in range(3)]

    # 1. preprocess only
    def pre(m, c, hh, o):
        return preprocess_gaussians(m, c, hh, o, extr, intr, (h, w), 2)

    rep("preprocess fwd", torch.no_grad()(pre), scenes)

    # 1b. preprocess fwd+bwd alone (no gather/scatter): the preprocess
    # backward apart from the instance gather's backward in stage 6.
    def pre_loss(m, c, hh, o):
        sc = pre(m, c, hh, o)
        return (sc.means2d.sum() + sc.conics.sum() + sc.opacities.sum()
                + sc.colors.sum() + sc.depths.sum())

    rep("preprocess fwd+bwd", _grad(pre_loss, (0, 1, 2, 3)), scenes)

    # 2. binning only (on preprocessed screens)
    with torch.no_grad():
        screens = [pre(*sc) for sc in scenes]

    @torch.no_grad()
    def binf(sc):
        return bin_gaussians(sc, (h, w), cap)

    rep("binning", binf, [(sc,) for sc in screens])

    # 3. instance-row build (gather) only
    bins = [binf(sc) for sc in screens]
    rep("instance rows gather", torch.no_grad()(build_instance_rows), list(zip(screens, bins)))

    # 4. forward kernel only
    tw = _tile_grid((h, w))[1]
    with torch.no_grad():
        instl = [build_instance_rows(sc, b) for sc, b in zip(screens, bins)]

    def kfwd(i, b):
        return composite_tiles_fwd(i, b.tile_start, b.tile_count, tw)

    rep("fwd kernel", kfwd, list(zip(instl, bins)))

    # 5. fwd+bwd kernel only (through the autograd function, grads wrt inst)
    def kernel_loss(i, b):
        out = composite_tiles(i, b.tile_start, b.tile_count, tw)
        return torch.sum(out[..., :4] ** 2)

    rep("fwd+bwd kernel", _grad(kernel_loss, (0,)), list(zip(instl, bins)))

    # 6. the instance gradients' reduction: the rows gather's backward
    def red_loss(m, c, hh, o, b):
        return torch.sum(build_instance_rows(pre(m, c, hh, o), b) ** 2)

    rep("preproc+gather fwd+bwd (incl. scatter reduction)", _grad(red_loss, (0, 1, 2, 3)),
        [sc + (b,) for sc, b in zip(scenes, bins)])

    # 7. full rasterize fwd / fwd+bwd
    def full(m, c, hh, o):
        return rasterize(m, c, hh, o, extr, intr, (h, w), bg, 2, capacity=cap)[0]

    rep("full fwd", torch.no_grad()(lambda *a: full(*a).sum()), scenes)
    rep("full fwd+bwd", _grad(lambda *a: torch.mean(full(*a) ** 2), (0, 1, 2, 3)), scenes)


def main(argv=None, device: str | None = None, shapes: Shapes | None = None) -> None:
    """Run the named stages (default ``DEFAULT_STAGES``) at ``shapes``
    (default the ScanNet 2-view ones on ``device``)."""
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("stages", nargs="*", choices=STAGES)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    s = shapes or Shapes(device=resolve_device(device or args.device))
    which = set(args.stages) or set(DEFAULT_STAGES)
    for name, fn in (("backbone", stage_backbone), ("cvenc", stage_cvenc),
                     ("dec", stage_dec), ("ptf", stage_ptf), ("adapter", stage_adapter),
                     ("raster", stage_raster)):
        if name in which:
            fn(s)
    variants = []
    if "train" in which:
        variants += [(True, "float32"), (False, "float32")]
    if "train_bf16" in which:
        variants += [(True, "bfloat16")]
    if variants:
        stage_train(s, variants)
    if "raster_sub" in which:
        raster_substages(s)


if __name__ == "__main__":
    main()
