"""EfficientNetV2-S feature backbone over NHWC tensors.

Port of ``freesplat_tpu/models/backbone.py`` (timm
``tf_efficientnetv2_s_in21ft1k``, ``features_only``): 5 feature maps at
strides 2/4/8/16/32 with channels (24, 48, 64, 160, 256).  Strided convs
use flax's ``padding="SAME"`` (asymmetric (0, 1) at stride 2).

``compute_dtype`` (bfloat16 for the tensor cores) is the activations'
dtype, as in the JAX module: the input is cast to it, every conv runs in
it, and each BatchNorm normalizes in float32 and returns it (flax's
``BatchNorm(dtype=x.dtype)``); parameters stay float32.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .layers import Conv, cast_at_use

# (block_type, kernel, stride, expand, out_ch, num_blocks, se_ratio)
EFFNETV2_S_CONFIG = (
    ("fused", 3, 1, 1, 24, 2, 0.0),
    ("fused", 3, 2, 4, 48, 4, 0.0),
    ("fused", 3, 2, 4, 64, 4, 0.0),
    ("mbconv", 3, 2, 4, 128, 6, 0.25),
    ("mbconv", 3, 1, 6, 160, 9, 0.25),
    ("mbconv", 3, 2, 6, 256, 15, 0.25),
)
STEM_CH = 24
FEATURE_STAGES = (0, 1, 2, 4, 5)
FEATURE_CHANNELS = (24, 48, 64, 160, 256)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-3)`` over NHWC channels.

    ``use_running_average=False`` normalizes with the batch statistics.  In
    ``train()`` mode it then updates the running buffers as flax does with
    a mutable ``batch_stats``: ``ra = 0.9 ra + 0.1 stat``, where the
    variance is the biased batch variance.  ``F.batch_norm`` updates with
    the unbiased one, ``n / (n - 1)`` times larger, so it writes that term
    into a zeroed buffer and the running variance takes it scaled back;
    the statistics come out of the same reduction that normalizes.  In
    ``eval()`` mode (serving) the buffers are never touched.  A bfloat16
    input is normalized with float32 statistics and parameters and
    returned in bfloat16.

    ``group`` (set by ``synced_batch_norm``; None by default): with a
    process group of more than one rank, batch statistics are those of the
    global batch, every rank's, as JAX's under a mesh: one differentiable
    all-reduce of the per-channel count, sum and sum of squares, the
    variance ``E[x^2] - E[x]^2`` as flax computes it, the running buffers
    updated from the global statistics.  With no group, or one rank, the
    path above runs unchanged."""

    def __init__(self, ch: int, use_running_average: bool):
        super().__init__()
        self.group = None
        self.use_running_average = use_running_average
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        if self.use_running_average:
            y = F.batch_norm(x.permute(0, 3, 1, 2), self.running_mean,
                             self.running_var, self.weight, self.bias,
                             training=False, eps=1e-3)
            return y.permute(0, 2, 3, 1)
        if self.group is not None and dist.get_world_size(self.group) > 1:
            return self._global_batch_norm(x)
        if not self.training:
            y = F.batch_norm(x.permute(0, 3, 1, 2), None, None, self.weight,
                             self.bias, training=True, eps=1e-3)
            return y.permute(0, 2, 3, 1)
        var_term = torch.zeros_like(self.running_var)  # becomes 0.1 * unbiased var
        y = F.batch_norm(x.permute(0, 3, 1, 2), self.running_mean, var_term,
                         self.weight, self.bias, training=True, momentum=0.1, eps=1e-3)
        n = x.numel() // x.shape[-1]
        with torch.no_grad():
            self.running_var.mul_(0.9).add_(var_term, alpha=(n - 1) / n)
        return y.permute(0, 2, 3, 1)

    def _global_batch_norm(self, x):
        from ..parallel.distributed import all_reduce_sum

        xf = x.float().reshape(-1, x.shape[-1])
        c = xf.shape[1]
        local = torch.cat([xf.sum(0), (xf * xf).sum(0), xf.new_full((1,), xf.shape[0])])
        total = all_reduce_sum(local, self.group)
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        y = (xf - mean) * (self.weight * torch.rsqrt(var + 1e-3)) + self.bias
        if self.training:
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(mean.detach(), alpha=0.1)
                self.running_var.mul_(0.9).add_(var.detach(), alpha=0.1)
        return y.reshape(x.shape).to(x.dtype)


@contextlib.contextmanager
def synced_batch_norm(module: nn.Module, group) -> Iterator[None]:
    """Inside, every ``BatchNorm`` of ``module`` normalizes with the
    statistics of ``group``'s global batch (see ``BatchNorm``); None leaves
    them local.  Restored on exit, so a rank's own work outside (its
    validation) takes no collective."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.group for m in bns]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m, g in zip(bns, saved):
            m.group = g


class BNAct(nn.Module):
    def __init__(self, ch: int, use_running_average: bool, act: bool = True):
        super().__init__()
        self.bn = BatchNorm(ch, use_running_average)
        self.act = act

    def forward(self, x):
        x = self.bn(x)
        return F.silu(x) if self.act else x


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced: int):
        super().__init__()
        self.reduce = Conv(ch, reduced, 1)
        self.expand = Conv(reduced, ch, 1)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class FusedMBConv(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride, expand, train_bn):
        super().__init__()
        ura = not train_bn
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            mid = in_ch * expand
            self.conv_exp = Conv(in_ch, mid, kernel, stride, "SAME", bias=False)
            self.bn1 = BNAct(mid, ura)
            self.conv_pwl = Conv(mid, out_ch, 1, bias=False)
            self.bn2 = BNAct(out_ch, ura, act=False)
        else:
            self.conv = Conv(in_ch, out_ch, kernel, stride, "SAME", bias=False)
            self.bn1 = BNAct(out_ch, ura)
        self.expand = expand

    def forward(self, x):
        inp = x
        if self.expand != 1:
            x = self.bn2(self.conv_pwl(self.bn1(self.conv_exp(x))))
        else:
            x = self.bn1(self.conv(x))
        return x + inp if self.residual else x


class MBConv(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride, expand, se_ratio, train_bn):
        super().__init__()
        ura = not train_bn
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == out_ch
        self.conv_pw = Conv(in_ch, mid, 1, bias=False)
        self.bn1 = BNAct(mid, ura)
        self.conv_dw = Conv(mid, mid, kernel, stride, "SAME", groups=mid, bias=False)
        self.bn2 = BNAct(mid, ura)
        self.se = (
            SqueezeExcite(mid, max(1, int(in_ch * se_ratio))) if se_ratio > 0 else None
        )
        self.conv_pwl = Conv(mid, out_ch, 1, bias=False)
        self.bn3 = BNAct(out_ch, ura, act=False)

    def forward(self, x):
        inp = x
        x = self.bn2(self.conv_dw(self.bn1(self.conv_pw(x))))
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv_pwl(x))
        return x + inp if self.residual else x


class EfficientNetV2S(nn.Module):
    """features_only EfficientNetV2-S: NHWC in, 5 NHWC feature maps out.

    ``train_bn``: normalize with batch statistics (the reference's BN mode
    at every forward, and the test-time default); else running averages.
    ``compute_dtype``: the activations' dtype (None: float32)."""

    def __init__(self, train_bn: bool = False, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        ura = not train_bn
        self.conv_stem = Conv(3, STEM_CH, 3, 2, "SAME", bias=False)
        self.bn_stem = BNAct(STEM_CH, ura)
        self.blocks = []
        ch = STEM_CH
        for si, (btype, k, s, e, out_ch, n, se) in enumerate(EFFNETV2_S_CONFIG):
            for bi in range(n):
                stride = s if bi == 0 else 1
                if btype == "fused":
                    block = FusedMBConv(ch, out_ch, k, stride, e, train_bn)
                else:
                    block = MBConv(ch, out_ch, k, stride, e, se, train_bn)
                self.add_module(f"stage{si}_block{bi}", block)
                self.blocks.append((si, bi == n - 1, f"stage{si}_block{bi}"))
                ch = out_ch
        cast_at_use(self, compute_dtype)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.bn_stem(self.conv_stem(x))
        features = []
        for si, last, name in self.blocks:
            x = getattr(self, name)(x)
            if last and si in FEATURE_STAGES:
                features.append(x)
        return features
