"""Reference torch checkpoints -> flax-layout parameter trees.

A copy of ``freesplat_tpu/utils/torch_convert.py``.  The reference takes
two pretrained torch models: timm's ``tf_efficientnetv2_s_in21ft1k``
(``encoder_freesplat.py:116-122``) and the ``lpips`` package's VGG16
(``loss_lpips.py:33``).  These converters map their state dicts onto the
flax-layout trees of ``models/backbone.EfficientNetV2S`` and
``training/lpips.LPIPS``, which ``utils/flax_bridge.py`` then loads into
the port's modules and ``training/lpips.py::save_lpips_params`` writes as
the keypath ``.npz`` both packages read.  Inputs are dicts of numpy arrays
or tensors (``torch.load(path, map_location="cpu", weights_only=True)``).

Conversion is strict both ways: a missing key raises ``KeyError``, and a
key that no rule consumed (other than the heads and counters the
features-only backbone and the frozen loss never read) raises
``ValueError``.  A silently dropped pretrained weight is the worst
conversion bug.

Layouts: torch conv weight (O, I, kh, kw) -> flax kernel (kh, kw, I, O);
depthwise (O, 1, kh, kw) -> (kh, kw, 1, O).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..models.backbone import EFFNETV2_S_CONFIG


class _KeyTracker(dict):
    """Records which state-dict keys a converter consumed."""

    def __init__(self, sd: Mapping):
        super().__init__({k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                          for k, v in sd.items()})
        self.consumed: set[str] = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)

    def __contains__(self, key):  # membership probes do not consume
        return super().__contains__(key)


# Keys a timm or lpips checkpoint carries that the features-only backbone
# and the frozen loss never read.
_IGNORABLE_SUFFIXES = (".num_batches_tracked",)
_IGNORABLE_PREFIXES = ("conv_head.", "classifier.", "bn2.")


def _check_consumed(tracker: _KeyTracker, what: str) -> None:
    unmapped = [k for k in tracker if k not in tracker.consumed
                and not k.endswith(_IGNORABLE_SUFFIXES) and not k.startswith(_IGNORABLE_PREFIXES)]
    if unmapped:
        raise ValueError(
            f"{what}: {len(unmapped)} state-dict keys were NOT consumed by the converter "
            f"(architecture mismatch?): {sorted(unmapped)[:20]}"
            + (" ..." if len(unmapped) > 20 else "")
        )


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _bn(prefix: str, sd):
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    return params, stats


def convert_efficientnetv2_s(sd: Mapping, strict: bool = True) -> tuple[dict, dict]:
    """timm tf_efficientnetv2_s state dict -> (params, batch_stats) trees of
    ``EfficientNetV2S`` (to be placed under the encoder's ``backbone``).
    The expected keys and shapes are frozen in
    ``tests/fixtures/timm_tf_efficientnetv2_s_manifest.json``."""
    sd = _KeyTracker(sd)
    params: dict = {}
    stats: dict = {}

    params["conv_stem"] = {"kernel": _conv(sd["conv_stem.weight"])}
    p, s = _bn("bn1", sd)
    params["bn_stem"] = {"bn": p}
    stats["bn_stem"] = {"bn": s}

    for si, (btype, _k, _s, expand, _ch, n_blocks, se_ratio) in enumerate(EFFNETV2_S_CONFIG):
        for bi in range(n_blocks):
            t = f"blocks.{si}.{bi}"
            bp: dict = {}
            bs: dict = {}

            def conv_bn(conv: str, bn: str, flax_conv: str | None = None):
                bp[flax_conv or conv] = {"kernel": _conv(sd[f"{t}.{conv}.weight"])}
                p, s = _bn(f"{t}.{bn}", sd)
                bp[bn] = {"bn": p}
                bs[bn] = {"bn": s}

            if btype == "fused" and expand == 1:  # timm ConvBnAct
                conv_bn("conv", "bn1")
            elif btype == "fused":  # timm EdgeResidual
                conv_bn("conv_exp", "bn1")
                conv_bn("conv_pwl", "bn2")
            else:  # timm InvertedResidual
                conv_bn("conv_pw", "bn1")
                conv_bn("conv_dw", "bn2")
                if se_ratio > 0:
                    bp["se"] = {
                        name: {"kernel": _conv(sd[f"{t}.se.conv_{name}.weight"]),
                               "bias": sd[f"{t}.se.conv_{name}.bias"]}
                        for name in ("reduce", "expand")
                    }
                conv_bn("conv_pwl", "bn3")
            params[f"stage{si}_block{bi}"] = bp
            stats[f"stage{si}_block{bi}"] = bs
    if strict:
        _check_consumed(sd, "convert_efficientnetv2_s")
    return params, stats


# torchvision vgg16.features conv layer indices per block.
_VGG16_CONV_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def convert_lpips_vgg(sd: Mapping, strict: bool = True) -> dict:
    """lpips-package state dict (``net.slice*`` + ``lins.*``, or the plain
    torchvision ``features.*`` / ``lin*`` names) -> the LPIPS variables
    ``{"params": ...}``."""
    sd = _KeyTracker(sd)
    vgg: dict = {}
    for bi, conv_ids in enumerate(_VGG16_CONV_IDX):
        for ci, idx in enumerate(conv_ids):
            # lpips names the vgg slices net.slice{1..5}.<features idx>.
            key_w = f"net.slice{bi + 1}.{idx}.weight"
            key_b = f"net.slice{bi + 1}.{idx}.bias"
            if key_w not in sd:  # the plain torchvision layout
                key_w, key_b = f"features.{idx}.weight", f"features.{idx}.bias"
            vgg[f"conv{bi}_{ci}"] = {"kernel": _conv(sd[key_w]), "bias": sd[key_b]}
    params: dict = {"vgg": vgg}
    for li in range(5):
        key = f"lins.{li}.model.1.weight"
        if key not in sd:
            key = f"lin{li}.model.1.weight"
        params[f"lin{li}"] = {"kernel": _conv(sd[key])}
    if strict:
        _check_consumed(sd, "convert_lpips_vgg")
    return {"params": params}
