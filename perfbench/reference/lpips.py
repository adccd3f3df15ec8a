"""Plain PyTorch reference of LPIPS (VGG16 features, NHWC images in [0, 1]).

A frozen copy of the port's module: features after each of VGG16's five
blocks, unit-normalized over channels, squared difference, 1x1 linear
heads, spatial mean, summed over the blocks.  Parameter names are the
port's, so one state dict loads into both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .model import Conv

VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        in_ch = 3
        for bi, (ch, n) in enumerate(VGG_BLOCKS):
            for ci in range(n):
                self.add_module(f"conv{bi}_{ci}", Conv(in_ch, ch, 3, 1, 1))
                in_ch = ch

    def forward(self, x):
        feats = []
        for bi, (_, n) in enumerate(VGG_BLOCKS):
            for ci in range(n):
                x = F.relu(getattr(self, f"conv{bi}_{ci}")(x))
            feats.append(x)
            if bi < len(VGG_BLOCKS) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return feats


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for li, (ch, _) in enumerate(VGG_BLOCKS):
            self.add_module(f"lin{li}", Conv(ch, 1, 1, bias=False))

    def forward(self, img0, img1):
        """(b, h, w, 3) in [0, 1] -> (b,) distances."""
        shift = torch.tensor(SHIFT, device=img0.device)
        scale = torch.tensor(SCALE, device=img0.device)
        f0 = self.vgg((2.0 * img0 - 1.0 - shift) / scale)
        f1 = self.vgg((2.0 * img1 - 1.0 - shift) / scale)
        total = 0.0
        for li, (a, b) in enumerate(zip(f0, f1)):
            a = a / torch.sqrt((a * a).sum(-1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(-1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{li}")((a - b) ** 2)[..., 0].mean(dim=(-1, -2))
        return total
