"""Overfit-one-scene quality proof at full resolution (384x512).

Port of ``freesplat_tpu/scripts/overfit_proof.py``.  Trains the full
pipeline from scratch on ONE synthetic multi-view scene through the CLI
path (``main`` in train mode), then evaluates the final checkpoint through
the test harness and writes the evidence (stats.json + summary) under
``--out``.

The reference's debugging analog is overfit_to_scene
(``src/dataset/dataset_scannet.py:75-77``); the acceptance bar is PSNR
>= 35 at 384x512 with gs_ratio < 1 on overlapping views.  Targets
interpolate between the context views (bounded-sampler protocol).

Usage (the GPU unless ``--device cpu``):
  python -m freesplat_tpu_torch.scripts.overfit_proof \
      [--steps 5000] [--out outputs/overfit384] [--image-shape 384,512]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None, device: str | None = None) -> dict:
    """Train, resume if ``--out`` holds a checkpoint, test; return the
    test summary.  ``device`` overrides ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--out", default="outputs/overfit384")
    p.add_argument("--image-shape", default="384,512")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--val-every", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = device or args.device

    h, w = (int(x) for x in args.image_shape.split(","))
    out = Path(args.out)
    ckpt = out / "ckpt"

    from ..main import main as cli
    from ..training.checkpoint import latest_step

    overrides = [
        "dataset.name=synthetic",
        f"dataset.image_shape=[{h},{w}]",
        "dataset.synthetic_cache_batches=1",
        f"trainer.max_steps={args.steps + 1}",
        f"trainer.val_check_interval={args.val_every}",
        "trainer.log_every=100",
        f"optimizer.max_steps={args.steps + 1}",
        "optimizer.warm_up_steps=200",
        f"optimizer.lr={args.lr}",
        "optimizer.gradient_clip_val=1.0",  # reference's 0.01 cripples
        f"checkpointing.output_dir={ckpt}",
        f"checkpointing.every_n_train_steps={args.val_every}",
    ]
    # Resume an interrupted run: the trainer restores the encoder, the
    # optimizer state and the step counter, so fit continues from the last
    # saved step (synthetic batches are seed-deterministic).
    if latest_step(str(ckpt)) is not None:
        overrides.append(f"checkpointing.load={ckpt}")
    cli(overrides, device=device)

    # Evaluate the trained checkpoint through the test harness on the
    # SAME cached scene (the synthetic generator is seed-deterministic).
    cli(
        [
            "mode=test",
            "dataset.name=synthetic",
            f"dataset.image_shape=[{h},{w}]",
            "dataset.synthetic_cache_batches=1",
            "test.max_scenes=1",
            f"checkpointing.load={ckpt}",
            f"test.output_path={out}/test",
        ],
        device=device,
    )
    stats = json.loads((out / "test" / "stats.json").read_text())
    print(json.dumps(stats["summary"], indent=2))
    return stats["summary"]


if __name__ == "__main__":
    main()
