"""Convert the reference's pretrained torch checkpoints to keypath .npz trees.

Port of ``freesplat_tpu/scripts/convert_weights.py``.  The reference
initializes its backbone from timm (``tf_efficientnetv2_s_in21ft1k``,
encoder_freesplat.py:116-122) and its perceptual loss from the ``lpips``
package's VGG16 (loss_lpips.py:33).  No such file ships with the
repository; given one, convert it once:

  python -m freesplat_tpu_torch.scripts.convert_weights lpips lpips_vgg.pth out.npz
      -> loss.lpips.weights_path=out.npz (the .pth itself also loads)

  python -m freesplat_tpu_torch.scripts.convert_weights backbone effnetv2s.pth out.npz
      -> graft into an encoder with load_backbone_npz

  python -m freesplat_tpu_torch.scripts.convert_weights verify {backbone|lpips} SRC.pth DST.npz
      [--device cpu]
      -> convert, then write DST.npz.verify.json: per-scale activation
         statistics of the port's backbone (or the port's LPIPS distances)
         on fixed probe images, run on the GPU unless --device says
         otherwise

The .npz holds flat "a/b/c" keypath arrays in the flax layout, the file
both packages write (``training/lpips.py::save_lpips_params``), so either
package reads the other's.  The comparison against timm or the ``lpips``
package that the JAX script makes where they are importable is not made:
the port imports neither, so ``timm_activation_max_abs_diff`` and
``lpips_pkg_max_abs_diff`` are null and the report says so.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Mapping

import numpy as np
import torch

from ..training.lpips import load_lpips_params, save_lpips_params
from ..utils.flax_bridge import load_flax_variables


def save_tree(tree: Mapping[str, Any], path: str) -> None:
    """Write a flax-layout tree as a keypath .npz (``save_lpips_params``)."""
    save_lpips_params(tree, path)


def load_tree_npz(path: str) -> dict:
    """Read a keypath .npz (either package's) as a nested dict of numpy
    arrays."""
    if not str(path).endswith(".npz"):
        raise ValueError(f"load_tree_npz: not a .npz file: {path}")
    return load_lpips_params(path)


def load_backbone_npz(encoder: torch.nn.Module, path: str) -> torch.nn.Module:
    """Graft converted backbone weights (``params`` and ``batch_stats``, as
    the ``backbone`` command writes them) onto ``encoder.backbone``,
    strictly and on its device; returns ``encoder``."""
    load_flax_variables(encoder.backbone, load_tree_npz(path))
    return encoder


def _probe_images(n: int = 2, hw: int = 64, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, hw, hw, 3)).astype(np.float32)


def verify_backbone(npz_path: str, device: str | torch.device = "cuda") -> dict:
    """The port's EfficientNetV2-S (running-average BN) with the converted
    weights on a fixed probe: per-scale shape, finiteness, mean and std."""
    from ..models.backbone import EfficientNetV2S
    from ..utils.device import resolve_device

    device = resolve_device(device)
    module = load_flax_variables(EfficientNetV2S(train_bn=False), load_tree_npz(npz_path))
    module = module.to(device).eval()
    with torch.no_grad():
        feats = module(torch.from_numpy(_probe_images()).to(device))
    report: dict = {"kind": "backbone", "scales": []}
    for f in feats:
        f = f.float().cpu().numpy()
        report["scales"].append({"shape": list(f.shape), "finite": bool(np.isfinite(f).all()),
                                 "mean": float(f.mean()), "std": float(f.std())})
    report["timm_activation_max_abs_diff"] = None
    report["note"] = ("timm is not imported by the port - structural and our-side forward "
                      "checks only (the strict key check ran during conversion)")
    return report


def verify_lpips(npz_path: str, device: str | torch.device = "cuda") -> dict:
    """The port's LPIPS with the converted weights: distances between fixed
    probe pairs, their finiteness and sign."""
    from ..training.lpips import make_lpips

    module = make_lpips(load_tree_npz(npz_path), device=device)
    dev = next(module.parameters()).device
    a, b = (torch.from_numpy(_probe_images(seed=s)).to(dev) for s in (5, 6))
    with torch.no_grad():
        ours = module(a, b).cpu().numpy()
    return {
        "kind": "lpips",
        "distances": [float(x) for x in np.ravel(ours)],
        "finite": bool(np.isfinite(ours).all()),
        "positive": bool((np.ravel(ours) > 0).all()),
        "lpips_pkg_max_abs_diff": None,
        "note": "the lpips package is not imported by the port - our-side distance checks only",
    }


def main(argv: list[str] | None = None, device: str | torch.device = "cuda") -> None:
    """The CLI; ``verify``'s forward pass runs on ``device`` (or the
    ``--device`` argument's)."""
    from ..utils.torch_convert import convert_efficientnetv2_s, convert_lpips_vgg

    argv = list(argv if argv is not None else sys.argv[1:])
    if "--device" in argv[:-1]:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    do_verify = bool(argv) and argv[0] == "verify"
    if do_verify:
        argv = argv[1:]
    if len(argv) != 3 or argv[0] not in ("lpips", "backbone"):
        print(__doc__)
        raise SystemExit(2)
    kind, src, dst = argv
    sd = torch.load(src, map_location="cpu", weights_only=True)
    if kind == "lpips":
        save_tree(convert_lpips_vgg(sd), dst)
    else:
        params, stats = convert_efficientnetv2_s(sd)
        save_tree({"params": params, "batch_stats": stats}, dst)
    print(f"wrote {dst}")

    if do_verify:
        report = (verify_lpips if kind == "lpips" else verify_backbone)(dst, device)
        out = f"{dst}.verify.json"
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
        print(json.dumps(report, indent=2))
        print(f"wrote {out}")
        bad = (not all(s["finite"] for s in report["scales"]) if kind == "backbone"
               else not report["finite"])
        if bad:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
