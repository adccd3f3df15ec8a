"""Basic building blocks over NHWC tensors.

Port of ``freesplat_tpu/models/layers.py``.  Feature maps stay NHWC as in
the JAX package; ``Conv`` permutes to an NCHW view around ``F.conv2d``
(a channels-last view, no copy).  Module and parameter names follow the
flax modules so ``utils/flax_bridge.py`` maps weights mechanically.

Compute dtype.  ``Conv`` and ``Dense`` hold a ``compute_dtype`` (None:
no cast): the input, kernel and bias are cast to it at use and the output
stays in it, as flax's ``nn.Conv(dtype=...)``/``nn.Dense(dtype=...)`` do;
parameters stay float32.  ``cast_at_use`` sets it on every such layer of
a module, where the flax module passes its ``dtype`` down.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _same_pad(size: tuple[int, int], kernel: int, stride: int) -> tuple[int, ...]:
    """flax/TF ``padding="SAME"``: total max((ceil(n/s)-1)*s + k - n, 0),
    the smaller half first.  At stride 2 on an even size that is (0, 1),
    where torch's ``padding=1`` would pad (1, 1)."""
    pads = []
    for n in size:
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads.append((total // 2, total - total // 2))
    (h_lo, h_hi), (w_lo, w_hi) = pads
    return (w_lo, w_hi, h_lo, h_hi)


def _cast(dtype, x, weight, bias):
    if dtype is None:
        return x, weight, bias
    return x.to(dtype), weight.to(dtype), None if bias is None else bias.to(dtype)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` over NHWC input; ``padding`` is an int or ``"SAME"``."""

    compute_dtype: torch.dtype | None = None

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1, bias=True):
        self.same = padding == "SAME"
        super().__init__(
            in_ch, out_ch, kernel, stride, 0 if self.same else padding,
            groups=groups, bias=bias,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = _cast(self.compute_dtype, x.permute(0, 3, 1, 2), self.weight, self.bias)
        if self.same:
            x = F.pad(x, _same_pad(x.shape[2:], self.kernel_size[0], self.stride[0]))
        return self._conv_forward(x, weight, bias).permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """``nn.Linear`` with flax's ``dtype``: ``compute_dtype`` (see above)."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*_cast(self.compute_dtype, x, self.weight, self.bias))


def compute_dtype_of(name: str) -> torch.dtype | None:
    """The cfg's ``compute_dtype`` string as a torch dtype; None for
    float32 (no cast)."""
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {name!r}")
    return None if name == "float32" else torch.bfloat16


def cast_at_use(module: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Set ``compute_dtype`` on every ``Conv`` and ``Dense`` in ``module``."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            m.compute_dtype = dtype
    return module


def leaky_relu_02(x):
    return F.leaky_relu(x, negative_slope=0.2)


class BasicBlock(nn.Module):
    """Residual block: conv3x3 -> lrelu -> conv3x3 (+ projection) -> lrelu."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_ch, features, 3, stride, 1)
        self.conv2 = Conv(features, features, 3, 1, 1)
        self.downsample = None
        if in_ch != features or stride != 1:
            k, pad = (1, 0) if stride == 1 else (3, 1)
            self.downsample = Conv(in_ch, features, k, stride, pad)

    def forward(self, x):
        out = self.conv2(leaky_relu_02(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return leaky_relu_02(out + identity)


class MLP(nn.Module):
    """Linear stack with LeakyReLU(0.01); children ``dense_{i}``."""

    def __init__(self, in_ch: int, channels, disable_final_activation: bool = False):
        super().__init__()
        self.disable_final_activation = disable_final_activation
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", Dense(in_ch, ch))
            in_ch = ch

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if not (i == self.n - 1 and self.disable_final_activation):
                x = F.leaky_relu(x, negative_slope=0.01)
        return x


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 of NHWC, align_corners=False, edges clamped:
    out[2i] = 0.25 x[i-1] + 0.75 x[i], out[2i+1] = 0.75 x[i] + 0.25 x[i+1]."""

    def interleave2(a, b, dim):
        shape = list(a.shape)
        shape[dim] *= 2
        return torch.stack([a, b], dim=dim + 1).reshape(shape)

    xm = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    xp = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    x = interleave2(0.25 * xm + 0.75 * x, 0.75 * x + 0.25 * xp, 1)
    xm = torch.cat([x[:, :, :1], x[:, :, :-1]], dim=2)
    xp = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
    return interleave2(0.25 * xm + 0.75 * x, 0.75 * x + 0.25 * xp, 2)


@functools.lru_cache(maxsize=64)
def _resize_matrix(src: int, dst: int, align_corners: bool) -> np.ndarray:
    """(dst, src) two-tap bilinear interpolation matrix (torch semantics)."""
    if align_corners and dst > 1:
        pos = np.linspace(0.0, src - 1.0, dst, dtype=np.float64)
    else:
        pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    p0 = np.clip(np.floor(pos), 0, src - 1)
    p1 = np.clip(p0 + 1, 0, src - 1)
    t = np.clip(pos - p0, 0.0, 1.0)
    m = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    m[rows, p0.astype(np.int64)] += (1.0 - t).astype(np.float32)
    m[rows, p1.astype(np.int64)] += t.astype(np.float32)
    return m


def interpolate_bilinear(
    x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """NHWC bilinear resize with torch's interpolate semantics, as two
    separable two-tap matmuls (the same weights as the JAX package), in
    float32 and returned in ``x``'s dtype."""
    n, h, w, c = x.shape
    ry = torch.from_numpy(_resize_matrix(h, out_hw[0], align_corners)).to(x.device)
    rx = torch.from_numpy(_resize_matrix(w, out_hw[1], align_corners)).to(x.device)
    out = torch.einsum("oh,nhwc->nowc", ry, x.float())
    return torch.einsum("pw,nowc->nopc", rx, out).to(x.dtype)
