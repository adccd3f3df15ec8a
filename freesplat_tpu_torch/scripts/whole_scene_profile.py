"""Per-phase attribution of the whole-scene (30-view) encode.

Port of ``freesplat_tpu/scripts/whole_scene_profile.py``.  Drives
``make_chunked_encode`` directly (no decode, no metrics) on a synthetic
30-view trajectory, ``--reps`` times: the first pass includes the
first-call costs (cuDNN's algorithm search, the kernels' loading), the
later ones are warm.  Each phase is fenced by a device synchronize
(``evaluation/harness.py::make_chunked_encode``'s ``timings``) and
printed under the JAX script's names: ``A_match``, ``A_geometry``,
``B_trunk_<first view of the chunk>``, ``B_concat``, ``C1_ptf``,
``C2_head`` and ``tail(head->host)``, in seconds.

Usage (the GPU unless ``--device cpu``):
  python -m freesplat_tpu_torch.scripts.whole_scene_profile \
      [--views 30] [--image-shape 384,512] [--chunk 15] [--reps 2]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

PHASES = ("A_match", "A_geometry", "B_trunk", "B_concat", "C1_ptf", "C2_head")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--views", type=int, default=30)
    p.add_argument("--image-shape", default="384,512")
    p.add_argument("--chunk", type=int, default=15)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--depth-candidates", type=int, default=128)
    p.add_argument(
        "--override", action="append", default=[],
        help="extra dotted config overrides (e.g. "
             "encoder.compute_dtype=bfloat16) for A/B sweeps",
    )
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def setup(args: argparse.Namespace):
    """(encode, context, timings): ONE chunked encode, reused across reps
    as ``run_test`` reuses it across scenes, on one synthetic scene."""
    from ..config.config import load_config
    from ..data.synthetic import SyntheticCfg, synthetic_batches
    from ..evaluation.harness import make_chunked_encode
    from ..models.encoder import make_encoder

    h, w = (int(x) for x in args.image_shape.split(","))
    cfg = load_config(
        [
            "dataset.name=synthetic",
            f"dataset.image_shape=[{h},{w}]",
            f"dataset.num_context_views={args.views}",
            f"encoder.num_depth_candidates={args.depth_candidates}",
            "encoder.num_views=5",
        ]
        + list(args.override)
    )
    t_gen = time.perf_counter()
    batch = next(
        synthetic_batches(
            SyntheticCfg(
                image_shape=(h, w), num_context=args.views, num_target=1,
                renderer="tile",  # datagen is not part of the timed encode
            ),
            device=args.device,
        )
    )
    context = {k: v for k, v in batch["context"].items() if k != "test_fvs"}
    print(f"data gen: {time.perf_counter() - t_gen:.1f} s", flush=True)

    encoder = make_encoder(dataclasses.replace(cfg.encoder, train_bn=False),
                           device=args.device, seed=0)
    timings: dict = {}
    encode = make_chunked_encode(encoder, args.chunk, timings=timings)
    return encode, context, timings


@torch.no_grad()
def run_rep(encode, context, timings: dict, chunk: int) -> tuple[float, dict]:
    """One encode: (total seconds, {phase: seconds}) with the JAX script's
    phase names; the phases and the tail sum to the total."""
    timings.clear()
    t0 = time.perf_counter()
    out = encode(context)
    int(out["num_gaussians"].sum())  # to the host, as JAX's device_get
    total = time.perf_counter() - t0
    deltas = {}
    for name in PHASES:
        spans = timings[f"{name}_s"]
        if name == "B_trunk":
            for i, t in enumerate(spans):
                deltas[f"B_trunk_{i * chunk}"] = t
        else:
            deltas[name] = spans[0]
    deltas["tail(head->host)"] = total - sum(deltas.values())
    return total, {k: round(v, 3) for k, v in deltas.items()}


def label(rep: int) -> str:
    return "cold" if rep == 0 else f"warm{rep}"


def main(argv=None, device: str | None = None) -> list[tuple[float, dict]]:
    args = parse_args(argv)
    if device is not None:
        args.device = device
    encode, context, timings = setup(args)
    chunk = args.chunk or args.views
    reps = []
    for rep in range(args.reps):
        total, deltas = run_rep(encode, context, timings, chunk)
        print(f"[{label(rep)}] total {total:.2f} s")
        print(json.dumps(deltas, indent=2), flush=True)
        reps.append((total, deltas))
    return reps


if __name__ == "__main__":
    main()
