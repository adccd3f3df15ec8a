"""Training with the LPIPS term active at full width: the whole reference
loss (MSE + 0.05 * LPIPS, reference ``src/loss/loss_lpips.py:27-55``)
through the port's ``main`` on the card, with its step time and device
memory under the VGG16 forward and backward at 384x512.

Port of ``freesplat_tpu/scripts/lpips_leg.py``.  No pretrained VGG ships
with the repository, so the checkpoint is a state dict synthesized from a
seed in the ``lpips`` package's layout (``net.slice*.N.weight`` and
``lins.N.model.1.weight``), converted by the port's conversion CLI
(``scripts/convert_weights.py``).  The loss value means nothing
perceptually; the compute path, memory and metrics are the production
ones.  The synthetic batch is drawn by the tile rasterizer (the dense
reference renderer's (n, h, w) intermediates take tens of GB at
384x512).

Usage:
  python -m freesplat_tpu_torch.scripts.lpips_leg [--steps 30]
      [--image-shape 384,512] [--out outputs/lpips_leg] [KEY=VALUE ...]

Trailing ``KEY=VALUE`` overrides go to ``main`` after the script's own.
Writes under ``--out``: the .pth and .npz, ``metrics_tail.jsonl`` (this
run's steps, ``loss_lpips`` among them) and ``memory.json``
(``torch.cuda.memory_stats()`` after the run; empty on the CPU).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

# VGG16 conv indices within each lpips ``net.slice{i}`` submodule (the
# torch layout ``utils/torch_convert.py::convert_lpips_vgg`` consumes).
_VGG16_CONV_IDX = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]


def synthesize_lpips_pth(path: Path, seed: int = 1) -> None:
    """A deterministic ``lpips``-layout state dict, as the JAX package's
    ``synthesize_lpips_pth`` draws it (the same numpy draws in order)."""
    rng = np.random.default_rng(seed)
    sd = {}
    chans = [(3, 64, 64), (64, 128, 128), (128, 256, 256, 256), (256, 512, 512, 512),
             (512, 512, 512, 512)]
    for bi, conv_ids in enumerate(_VGG16_CONV_IDX):
        io = chans[bi]
        for ci, idx in enumerate(conv_ids):
            # He-scaled so that activations stay finite through 13 convs.
            fan_in = io[ci] * 9
            sd[f"net.slice{bi + 1}.{idx}.weight"] = torch.from_numpy(
                (rng.normal(size=(io[ci + 1], io[ci], 3, 3))
                 * np.sqrt(2.0 / fan_in)).astype(np.float32))
            sd[f"net.slice{bi + 1}.{idx}.bias"] = torch.zeros(io[ci + 1])
    for li, c in enumerate([64, 128, 256, 512, 512]):
        sd[f"lins.{li}.model.1.weight"] = torch.from_numpy(
            rng.uniform(0, 1, size=(1, c, 1, 1)).astype(np.float32))
    torch.save(sd, path)


def main(argv=None, device: str | torch.device = "cuda") -> dict:
    """Run the leg; returns ``torch.cuda.memory_stats()`` after it ({} on
    the CPU)."""
    from ..main import main as cli
    from ..utils.device import resolve_device
    from .convert_weights import main as convert

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--image-shape", default="384,512")
    p.add_argument("--out", default="outputs/lpips_leg")
    p.add_argument("overrides", nargs="*", help="KEY=VALUE overrides for main")
    args = p.parse_args(argv)
    device = resolve_device(device)
    h, w = (int(x) for x in args.image_shape.split(","))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    pth = out / "lpips_synthetic.pth"
    npz = out / "lpips_synthetic.npz"
    synthesize_lpips_pth(pth)
    convert(["lpips", str(pth), str(npz)], device=device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cli([
        "dataset.name=synthetic",
        "dataset.synthetic_renderer=tile",
        f"dataset.image_shape=[{h},{w}]",
        "dataset.synthetic_cache_batches=1",
        f"trainer.max_steps={args.steps + 1}",
        "trainer.val_check_interval=100000000",
        "trainer.log_every=5",
        f"optimizer.max_steps={args.steps + 1}",
        "optimizer.warm_up_steps=5",
        "loss.lpips.weight=0.05",
        "loss.lpips.apply_after_step=0",
        f"loss.lpips.weights_path={npz}",
        f"checkpointing.output_dir={out}/ckpt",
        "checkpointing.every_n_train_steps=100000000",
        *args.overrides,
    ], device=device)
    # The trainer logs to outputs/local/metrics.jsonl: copy this run's
    # steps (loss_lpips among them) next to the other outputs.
    src = Path("outputs/local/metrics.jsonl")
    if src.exists():
        lines = src.read_text().strip().splitlines()
        (out / "metrics_tail.jsonl").write_text("\n".join(lines[-(args.steps + 5):]) + "\n")

    stats = dict(torch.cuda.memory_stats(device)) if device.type == "cuda" else {}
    (out / "memory.json").write_text(json.dumps(stats, indent=2, default=int))
    print("peak_bytes_in_use:", stats.get("allocated_bytes.all.peak"))
    return stats


if __name__ == "__main__":
    main()
