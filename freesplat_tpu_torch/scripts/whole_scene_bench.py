"""Whole-scene encode on one card: 30 context views at 384x512.

Port of ``freesplat_tpu/scripts/whole_scene_bench.py`` (reference
protocol: ``assets/evaluation_index_scannet_30views.json`` with chunked
rendering).  Drives ``run_test`` over synthetic scenes (a fresh Gaussian
cloud each, rendered by the tile rasterizer) at the ``scannet/fvt``
preset's model shape (nearest-5 sources, D = 128), with the trunk encoded
``test.encode_view_chunk=15`` views at a time and
``test.render_capacity_factor=1.0``, and prints the encode time per scene,
its phase split, the render time per view, ``gs_ratio``,
``num_gaussians``, the instances dropped and the peak device memory.

Usage:
  python -m freesplat_tpu_torch.scripts.whole_scene_bench \\
      [--views 30] [--image-shape 384,512] [--out outputs/whole_scene30] \\
      [--device cuda] [encoder.compute_dtype=bfloat16 ...]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch


def bench_config(views: int, h: int, w: int, out: str, depth_candidates: int = 128,
                 ckpt: str | None = None, overrides=()):
    """The benchmark's config: the synthetic dataset at the fvt preset's
    model shape, 15 views a trunk chunk, capacity factor 1.0, no depth
    dumps; ``overrides`` (dotted, e.g. ``test.encode_view_chunk=5``) go
    last."""
    from ..config.config import load_config

    args = [
        "dataset.name=synthetic",
        f"dataset.image_shape=[{h},{w}]",
        f"dataset.num_context_views={views}",
        f"encoder.num_depth_candidates={depth_candidates}",
        "encoder.num_views=5",  # the fvt preset's nearest-k
        f"test.output_path={out}",
        "test.save_depth=false",
        "test.encode_view_chunk=15",
        "test.render_capacity_factor=1.0",
    ]
    if ckpt:
        args += [f"checkpointing.load={ckpt}", "checkpointing.strict=false"]
    return load_config([*args, *overrides])


def main(argv=None, device: str | torch.device = "cuda") -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--views", type=int, default=30)
    p.add_argument("--targets", type=int, default=8)
    p.add_argument("--image-shape", default="384,512")
    p.add_argument("--out", default="outputs/whole_scene30")
    p.add_argument("--depth-candidates", type=int, default=128)
    # The first scene carries the first calls' set-up; the second is warm.
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--ckpt", default=None, help="checkpoint dir for a trained-net run")
    p.add_argument("--device", default=device)
    p.add_argument("overrides", nargs="*", help="dotted config overrides")
    args = p.parse_args(argv)
    h, w = (int(x) for x in args.image_shape.split(","))

    from ..data.synthetic import SyntheticCfg, synthetic_batches
    from ..evaluation.harness import run_test

    cfg = bench_config(args.views, h, w, args.out, args.depth_candidates, args.ckpt,
                       args.overrides)
    batches = synthetic_batches(
        SyntheticCfg(image_shape=(h, w), num_context=args.views, num_target=args.targets,
                     renderer="tile", vary_scene=True),
        device=args.device,
    )
    timings: dict = {}
    summary = run_test(cfg, batches=batches, max_scenes=args.scenes, device=args.device,
                       timings=timings)
    bench = json.loads((Path(args.out) / "benchmark.json").read_text())
    peak = json.loads((Path(args.out) / "peak_memory.json").read_text())
    peak_bytes = {k: v.get("max_memory_allocated") for k, v in peak.items()}
    print(json.dumps(summary, indent=2, default=float))
    print(f"views={args.views} {h}x{w}: encoder {bench.get('encoder')} s/scene, decoder "
          f"{bench.get('decoder')} s/view, phases "
          + ", ".join(f"{k} {[round(t, 4) for t in v]}" for k, v in timings.items()
                      if k[:2] in ("A_", "B_", "C1", "C2"))
          + f"; gs_ratio={summary.get('gs_ratio'):.4f}, num_gaussians="
          f"{summary.get('num_gaussians')}, dropped={summary.get('dropped_instances')}, "
          f"peak={peak_bytes} B", flush=True)
    return {"summary": summary, "timings": timings, "peak": peak_bytes}


if __name__ == "__main__":
    main()
