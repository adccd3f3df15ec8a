"""LPIPS perceptual distance (VGG16 backbone) over NHWC images.

Port of ``freesplat_tpu/training/lpips.py``: VGG16 features at relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3, unit-normalized over channels,
squared difference, 1x1 linear heads, spatial mean, summed over layers.
Inputs in [0, 1] are shifted and scaled by the ``lpips`` package's
constants.  Modules are named as in flax (``vgg.conv{b}_{c}``, ``lin{l}``),
so ``utils/flax_bridge.py`` maps a flax LPIPS tree strictly.  No
pretrained weights ship with the repository; ``load_lpips_params`` reads
``.npz`` files in the JAX package's layout and ``lpips``-package ``.pth``
state dicts (through ``utils/torch_convert.py``).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv

# VGG16 conv plan: (channels, num convs) per block.
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        in_ch = 3
        for bi, (ch, n_convs) in enumerate(_VGG_BLOCKS):
            for ci in range(n_convs):
                self.add_module(f"conv{bi}_{ci}", Conv(in_ch, ch, 3, 1, 1))
                in_ch = ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for bi, (_, n_convs) in enumerate(_VGG_BLOCKS):
            for ci in range(n_convs):
                x = F.relu(getattr(self, f"conv{bi}_{ci}")(x))
            feats.append(x)
            if bi < len(_VGG_BLOCKS) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return feats


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for li, (ch, _) in enumerate(_VGG_BLOCKS):
            self.add_module(f"lin{li}", Conv(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """(b, h, w, 3) images in [0, 1] -> (b,) LPIPS distances."""

        def norm_input(x):
            return (2.0 * x - 1.0 - self.shift) / self.scale

        f0 = self.vgg(norm_input(img0))
        f1 = self.vgg(norm_input(img1))
        total = 0.0
        for li, (a, b) in enumerate(zip(f0, f1)):
            a = a / torch.sqrt((a * a).sum(-1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(-1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{li}")((a - b) ** 2)
            total = total + lin[..., 0].mean(dim=(-1, -2))
        return total


def make_lpips(params: Mapping[str, Any] | None = None, device="cuda", seed: int = 0) -> LPIPS:
    """A frozen LPIPS on ``device``: weights from a flax-layout tree
    (``{"params": ...}``, e.g. from ``load_lpips_params``), else from
    ``seed`` as flax initializes them."""
    from ..models.encoder import init_like_flax
    from ..utils.device import resolve_device
    from ..utils.flax_bridge import load_flax_variables

    module = LPIPS()
    if params is None:
        init_like_flax(module, seed)
    else:
        load_flax_variables(module, params)
    module.requires_grad_(False)
    return module.to(resolve_device(device)).eval()


def save_lpips_params(params: Mapping[str, Any], path: str) -> None:
    """Serialize an LPIPS variables tree to .npz (keypaths joined by /)."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(params, "")
    np.savez(path, **flat)


def load_lpips_params(path: str) -> dict:
    """Load LPIPS variables as a nested dict of numpy arrays: a keypath
    ``.npz`` written by ``save_lpips_params`` (either package's), or a
    torch state dict of the ``lpips`` package or torchvision, converted
    strictly by ``utils/torch_convert.py::convert_lpips_vgg``."""
    if not str(path).endswith(".npz"):
        from ..utils.torch_convert import convert_lpips_vgg

        return convert_lpips_vgg(torch.load(path, map_location="cpu", weights_only=True))
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
    return tree
