"""Upper readings for the limits of ``correct``: the control and the faults,
each put in the program's place and compared with the reference exactly
as a run compares the program.

- ``tf32``, the control: the reference itself with TF32 on (the precision
  below the configurations' float32 with TF32 off).
- Training's faults, planted in the reference: ``half_batch`` (the loss
  over the first half of the target views only, the mean taken over
  them), ``altered`` (each step's first rendered view brightened by 0.01
  where it is produced).  A state left unchanged reads 1 by the measure of
  ``change_rel`` and needs no run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 13 [--device cuda]

Prints one JSON line per seed and variant with the numbers compared.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.entries import common, fit, run_test  # noqa: E402
from perfbench.reference import steps  # noqa: E402
from perfbench.scenes import make_pool, to_device  # noqa: E402


@contextlib.contextmanager
def tf32(on: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def altered_render():
    """Each call's first rendered view brightened by 0.01."""
    original = steps.render_targets

    def render(encoder, gaussians, target, image_shape):
        color = original(encoder, gaussians, target, image_shape)
        return torch.cat([color[:1] + 0.01, color[1:]])

    steps.render_targets = render
    try:
        yield
    finally:
        steps.render_targets = original


def _half(batch):
    tgt = batch["target"]
    n = tgt["image"].shape[1] // 2
    return {"context": batch["context"], "target": {k: v[:, :n] for k, v in tgt.items()}}


def train_readings(cell, seed, device):
    o = cell.config["overrides"]
    pool = make_pool(cell.traffic, o, seed, device)
    batches = [{k: to_device(pool[i][k], device) for k in ("context", "target")}
               for i in range(fit.COMPARED_STEPS)]

    def steps_of(variant):
        enc_sd, lp_sd = common.draw_weights(cell, seed, device)
        enc, lp = common.load_reference(cell, enc_sd, lp_sd, device)
        feed = [_half(b) for b in batches] if variant == "half_batch" else batches
        with tf32(variant == "tf32"), (altered_render() if variant == "altered"
                                      else contextlib.nullcontext()):
            out = steps.train_steps(enc, lp, o, feed)
        out["dropped"] = [0.0] * fit.COMPARED_STEPS
        out["logged_loss"] = out["loss"][0]
        return out

    ref = steps_of("reference")
    for variant in ("tf32", "half_batch", "altered"):
        checks = fit.compare(steps_of(variant), ref, cell.workload["limits"])
        yield variant, {c.name: c.value for c in checks}


def serve_readings(cell, seed, device, out_dir: Path):
    """The control's PNGs are written and compared as the program's are."""
    from PIL import Image

    o = cell.config["overrides"]
    pool = make_pool(cell.traffic, o, seed, device)
    enc_sd, lp_sd = common.draw_weights(cell, seed, device)
    enc, lp = common.load_reference(cell, enc_sd, lp_sd, device)
    refs, judged, entries = {}, [], []
    for j in range(len(pool)):
        batch = {k: to_device(pool[j][k], device) for k in ("context", "target")}
        color, metrics = steps.eval_scene(enc, lp, batch, o["test.encode_view_chunk"])
        refs[j] = (run_test._quantize(color), metrics)
        with tf32(True):
            color, metrics = steps.eval_scene(enc, lp, batch, o["test.encode_view_chunk"])
        scene = f"control-pool{j}"
        for vi, png in enumerate(run_test._quantize(color)):
            path = out_dir / scene / "color" / f"{vi:04}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(png).save(path)
        judged.append((scene, j))
        entries.append({**metrics, "dropped_instances": 0.0})
    checks = run_test.compare(out_dir, judged, entries, refs, cell.workload["limits"])
    yield "tf32", {c.name: c.value for c in checks}


def readings(cell, seed: int, device, out_dir: Path):
    """(variant, {number compared: reading}) of ``cell`` at ``seed``."""
    if cell.traffic["entry"] == "fit":
        return list(train_readings(cell, seed, device))
    return list(serve_readings(cell, seed, device, out_dir))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="build/perfbench/calibrate")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for variant, values in readings(cell, seed, args.device, Path(args.out) / str(seed)):
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant,
                              **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
