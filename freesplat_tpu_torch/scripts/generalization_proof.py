"""Held-out multi-scene generalization proof.

Port of ``freesplat_tpu/scripts/generalization_proof.py``: the in-image
proxy for the reference's ScanNet quality gate
(``src/model/model_wrapper.py:305-443``).  The reference's value
proposition is *generalizable* feed-forward reconstruction, so train on a
stream of fresh random Gaussian scenes and evaluate on scenes NEVER
trained on, against two baselines:

- ``nearest_context``: copy the nearest (pose-distance) context image —
  what a model that learned nothing about geometry could do at best.
- ``untrained``: the same architecture with random init.

Scenes are (seed, scene_id)-keyed; the train stream (seed = data_loader.seed)
and the eval stream (seed = EVAL_SEED) are disjoint scene sets.

Usage (the GPU unless ``--device cpu``):
  python -m freesplat_tpu_torch.scripts.generalization_proof train \
      [--steps 40000] [--image-shape 192,256] [--contexts 3]
  python -m freesplat_tpu_torch.scripts.generalization_proof eval \
      [--scenes 20] [--out outputs/generalization/eval]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

OUT_DEFAULT = "outputs/generalization/eval"
CKPT_DEFAULT = "outputs/generalization/ckpt"
EVAL_SEED = 99990  # the train stream uses data_loader.seed (default 1234)


def _common_overrides(args) -> list[str]:
    h, w = (int(x) for x in args.image_shape.split(","))
    return [
        "dataset.name=synthetic",
        f"dataset.image_shape=[{h},{w}]",
        f"dataset.num_context_views={args.contexts}",
        f"dataset.synthetic_num_targets={args.targets}",
        "dataset.synthetic_vary_scene=true",
        "dataset.synthetic_cache_batches=0",
        f"dataset.synthetic_renderer={args.renderer}",
        f"encoder.num_views={args.contexts}",
    ]


def train(args) -> None:
    from ..main import main as cli
    from ..training.checkpoint import latest_step

    ckpt = Path(args.ckpt)
    overrides = _common_overrides(args) + [
        f"trainer.max_steps={args.steps + 1}",
        "trainer.val_check_interval=100000000",  # eval is the separate mode
        "trainer.log_every=200",
        f"optimizer.max_steps={args.steps + 1}",
        "optimizer.warm_up_steps=500",
        f"optimizer.lr={args.lr}",
        f"optimizer.gradient_clip_val={args.clip}",
        f"checkpointing.output_dir={ckpt}",
        f"checkpointing.every_n_train_steps={args.save_every}",
    ]
    if latest_step(str(ckpt)) is not None:
        overrides.append(f"checkpointing.load={ckpt}")  # resume
    cli(overrides, device=args.device)


@torch.no_grad()
def _nearest_context_baseline(batch) -> tuple[float, float]:
    """Mean PSNR/SSIM over the targets of the nearest (pose-distance)
    context image."""
    from ..models.encoder import pose_distance_matrix
    from ..training.metrics import compute_psnr, compute_ssim

    ctx_e = torch.as_tensor(batch["context"]["extrinsics"][0])
    tgt_e = torch.as_tensor(batch["target"]["extrinsics"][0])
    dist = pose_distance_matrix(torch.cat([ctx_e, tgt_e]))
    nc = ctx_e.shape[0]
    nearest = torch.argmin(dist[nc:, :nc], dim=1)  # (num_targets,)
    pred = torch.as_tensor(batch["context"]["image"][0])[nearest]
    gt = torch.as_tensor(batch["target"]["image"][0])
    psnr = compute_psnr(gt, pred)
    ssim = compute_ssim(gt, pred)
    return float(psnr.mean()), float(ssim.mean())


def evaluate(args) -> dict:
    from ..config.config import load_config
    from ..data.synthetic import SyntheticCfg, synthetic_batches
    from ..evaluation.harness import run_test

    h, w = (int(x) for x in args.image_shape.split(","))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def batches():
        return synthetic_batches(
            SyntheticCfg(
                image_shape=(h, w),
                num_context=args.contexts,
                num_target=args.targets,
                seed=EVAL_SEED,
                vary_scene=True,
                renderer=args.renderer,
            ),
            device=args.device,
        )

    # Baseline: nearest-context copy over the SAME held-out scenes.
    nc_psnr, nc_ssim = [], []
    gen = batches()
    for _ in range(args.scenes):
        p, s = _nearest_context_baseline(next(gen))
        nc_psnr.append(p)
        nc_ssim.append(s)
    nearest = {
        "psnr": float(np.mean(nc_psnr)),
        "ssim": float(np.mean(nc_ssim)),
    }
    print("[generalization] nearest-context:", nearest, flush=True)

    def run(tag: str, load: str | None):
        overrides = _common_overrides(args) + [
            "mode=test",
            f"test.output_path={out}/{tag}",
            f"data_loader.seed={EVAL_SEED}",
            "test.save_depth=false",
        ]
        if load:
            overrides.append(f"checkpointing.load={load}")
        cfg = load_config(overrides)
        return run_test(cfg, batches=batches(), max_scenes=args.scenes, device=args.device)

    untrained = run("untrained", None) if not args.skip_untrained else None
    trained = run("trained", args.ckpt)

    report = {
        "protocol": {
            "image_shape": [h, w],
            "contexts": args.contexts,
            "targets": args.targets,
            "held_out_scenes": args.scenes,
            "eval_seed": EVAL_SEED,
            "renderer": args.renderer,
        },
        "trained": trained,
        "untrained": untrained,
        "nearest_context": nearest,
    }
    (out / "stats.json").write_text(json.dumps(report, indent=2, default=float))
    print(json.dumps(report, indent=2, default=float))
    return report


def main(argv=None, device: str | None = None):
    """``train`` or ``eval`` as the command line says; ``device``
    overrides ``--device``.  Returns the report of ``eval``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["train", "eval"])
    p.add_argument("--steps", type=int, default=40000)
    p.add_argument("--image-shape", default="192,256")
    p.add_argument("--contexts", type=int, default=3)
    p.add_argument("--targets", type=int, default=2)
    # 2e-4 diverged at ~step 5.5k on the fresh-scene stream in the JAX
    # package's run; 1e-4 is the reference's ScanNet setting.
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--clip", type=float, default=0.5)
    p.add_argument("--save-every", type=int, default=2000)
    p.add_argument("--ckpt", default=CKPT_DEFAULT)
    p.add_argument("--out", default=OUT_DEFAULT)
    p.add_argument("--scenes", type=int, default=20)
    p.add_argument("--renderer", default="tile")
    p.add_argument("--skip-untrained", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if device is not None:
        args.device = device
    if args.mode == "train":
        return train(args)
    return evaluate(args)


if __name__ == "__main__":
    main()
