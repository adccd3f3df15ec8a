"""Encoder sub-networks: CVEncoder, DepthDecoder (dense grid), GRU.

Port of ``freesplat_tpu/models/networks.py``.  NHWC feature maps; module
names follow the flax modules (``right_conv_{i}{j}``, ``in_conv_{i}{j}``,
``mlp_r_0`` ...), so weights bridge mechanically.  ``compute_dtype`` casts
where the flax modules' ``dtype`` does: CVEncoder's and DepthDecoder's
inputs and every conv; the depth softmax and ``output_s-1`` are float32.
The GRU runs in float32, as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .backbone import FEATURE_CHANNELS
from .layers import BasicBlock, Conv, cast_at_use, interpolate_bilinear, upsample2x


class DoubleBasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.block0 = BasicBlock(in_ch, features)
        self.block1 = BasicBlock(features, features)

    def forward(self, x):
        return self.block1(self.block0(x))


class CVEncoder(nn.Module):
    """Fuses the cost volume with image features over 4 scales.

    Block i: ds_conv (stride 2 except the first) -> concat backbone feature
    scale i -> 2 residual blocks.  Returns the 4 fused scales."""

    def __init__(self, in_ch: int, img_chs=FEATURE_CHANNELS[1:],
                 num_ch_outs=(64, 128, 256, 384), compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.n = len(num_ch_outs)
        for i, ch in enumerate(num_ch_outs):
            self.add_module(f"ds_conv_{i}", BasicBlock(in_ch, ch, 1 if i == 0 else 2))
            self.add_module(f"conv_{i}a", BasicBlock(ch + img_chs[i], ch))
            self.add_module(f"conv_{i}b", BasicBlock(ch, ch))
            in_ch = ch
        self.num_ch_outs = tuple(num_ch_outs)
        self.compute_dtype = compute_dtype
        cast_at_use(self, compute_dtype)

    def forward(self, cost_volume, img_feats):
        x = cost_volume
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        outputs = []
        for i in range(self.n):
            x = getattr(self, f"ds_conv_{i}")(x)
            x = torch.cat([x, img_feats[i].to(x.dtype)], dim=-1)
            x = getattr(self, f"conv_{i}b")(getattr(self, f"conv_{i}a")(x))
            outputs.append(x)
        return outputs


class DepthDecoder(nn.Module):
    """Dense-grid decoder -> per-scale depth distributions + feature maps.

    Node (i, j) is scale i after column j; column 0 is the input.  Inputs
    of (i, j): right = (i, j-1), diag = (i+1, j-1), up = (i+1, j).
    Outputs as the JAX module: output_s{i}, depth_s{i}, log_depth_s{i}
    (i = 0..3), depth_s-1, output_s-1 and depth_weights at full resolution.
    """

    def __init__(self, in_chs, num_output_channels: int = 65, near: float = 0.5,
                 far: float = 15.0, num_samples: int = 64, log_planes: bool = True,
                 num_ch_dec=(64, 64, 128, 256), max_depth: int = 4,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.near, self.far = near, far
        self.num_samples = num_samples
        self.log_planes = log_planes
        self.md = md = max_depth
        ch_of = {(i, 0): c for i, c in enumerate(in_chs)}
        for j in range(1, md + 1):
            for i in range(md - j, -1, -1):
                ch = num_ch_dec[i]
                self.add_module(f"right_conv_{i}{j - 1}", BasicBlock(ch_of[(i, j - 1)], ch))
                self.add_module(f"diag_conv_{i + 1}{j - 1}",
                                BasicBlock(ch_of[(i + 1, j - 1)], ch))
                n_in = 2
                if i + j != md:
                    self.add_module(f"up_conv_{i + 1}{j}", BasicBlock(ch_of[(i + 1, j)], ch))
                    n_in = 3
                self.add_module(f"in_conv_{i}{j}", DoubleBasicBlock(n_in * ch, ch))
                ch_of[(i, j)] = ch
                if i + j == md:
                    if i != 0:
                        self.add_module(f"output_pre_{i}", BasicBlock(ch, ch))
                    self.add_module(f"output_{i}", Conv(ch, num_output_channels, 1))
        for i in range(md - 1, -1, -1):
            self.add_module(f"conv_depth_{i}a", BasicBlock(num_output_channels, num_samples))
            self.add_module(f"conv_depth_{i}b", Conv(num_samples, num_samples, 1))
        self.conv_last_a = BasicBlock(num_output_channels, 128)
        self.conv_last_b = Conv(128, num_output_channels, 1)
        cast_at_use(self, compute_dtype)

    def depth_candidates(self, device) -> torch.Tensor:
        t = torch.linspace(0.0, 1.0, self.num_samples, device=device)
        if self.log_planes:
            return math.log(self.near) + t * math.log(self.far / self.near)
        return (1.0 / self.near) + t * (1.0 / self.far - 1.0 / self.near)

    def forward(self, input_features) -> dict[str, torch.Tensor]:
        md = self.md
        dtype = self.compute_dtype
        node = {(i, 0): f if dtype is None else f.to(dtype) for i, f in enumerate(input_features)}
        head_out = {}
        for j in range(1, md + 1):
            for i in range(md - j, -1, -1):
                inputs = [
                    getattr(self, f"right_conv_{i}{j - 1}")(node[(i, j - 1)]),
                    upsample2x(getattr(self, f"diag_conv_{i + 1}{j - 1}")(node[(i + 1, j - 1)])),
                ]
                if i + j != md:
                    inputs.append(upsample2x(getattr(self, f"up_conv_{i + 1}{j}")(node[(i + 1, j)])))
                x = getattr(self, f"in_conv_{i}{j}")(torch.cat(inputs, dim=-1))
                node[(i, j)] = x
                if i + j == md:
                    h = getattr(self, f"output_pre_{i}")(x) if i != 0 else x
                    head_out[i] = getattr(self, f"output_{i}")(h)

        outputs = {}
        candidates = self.depth_candidates(input_features[0].device)
        for i in range(md - 1, -1, -1):
            outputs[f"output_s{i}"] = head_out[i]
            planes = getattr(self, f"conv_depth_{i}b")(
                getattr(self, f"conv_depth_{i}a")(head_out[i])
            )
            planes = torch.softmax(planes.float(), dim=-1)  # (n, h, w, D) float32
            disps = (planes * candidates).sum(-1, keepdim=True)
            outputs[f"depth_s{i}"] = torch.exp(disps) if self.log_planes else 1.0 / disps
            outputs[f"log_depth_s{i}"] = disps
            if i == 0:
                coarse_disps, depth_planes0 = disps, planes

        _, h0, w0, _ = coarse_disps.shape
        fine = interpolate_bilinear(coarse_disps, (2 * h0, 2 * w0), align_corners=True)
        outputs["depth_s-1"] = torch.exp(fine) if self.log_planes else 1.0 / fine
        x = self.conv_last_a(upsample2x(head_out[0]))
        outputs["output_s-1"] = self.conv_last_b(x).float()
        outputs["depth_weights"] = interpolate_bilinear(
            depth_planes0, (2 * h0, 2 * w0), align_corners=True
        ).amax(-1, keepdim=True)
        return outputs


class GRU(nn.Module):
    """Gated latent fusion of overlapping Gaussians' features."""

    def __init__(self, hidden_channel: int = 64, emb_ch: int = 24):
        super().__init__()
        hc = hidden_channel
        gate_in = 2 * (hc + emb_ch)
        for name, d_in in (("mlp_r", gate_in), ("mlp_z", gate_in), ("mlp_n", hc + hc + emb_ch)):
            self.add_module(f"{name}_0", nn.Linear(d_in, hc))
            self.add_module(f"{name}_1", nn.Linear(hc, hc))

    def _mlp(self, name, x):
        return getattr(self, f"{name}_1")(F.relu(getattr(self, f"{name}_0")(x)))

    def forward(self, input_feat, hidden_feat, input_weights_emb, hidden_weights_emb):
        input_1 = torch.cat([input_feat, input_weights_emb], dim=-1)
        hidden_1 = torch.cat([hidden_feat, hidden_weights_emb], dim=-1)
        concat = torch.cat([hidden_1, input_1], dim=-1)
        r = torch.sigmoid(self._mlp("mlp_r", concat))
        z = torch.sigmoid(self._mlp("mlp_z", concat))
        update = torch.cat([r * hidden_feat, input_1], dim=-1)
        q = torch.tanh(self._mlp("mlp_n", update))
        return (1.0 - z) * hidden_feat + z * q


def positional_encoding(positions: torch.Tensor, freqs: int) -> torch.Tensor:
    """(..., D) -> (..., 2*D*freqs): per input dim its freqs, and per value
    sin then cos, interleaved (the JAX package's order)."""
    freq_bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype, device=positions.device)
    pts = (positions[..., None] * freq_bands).reshape(
        *positions.shape[:-1], freqs * positions.shape[-1]
    )
    return torch.stack([torch.sin(pts), torch.cos(pts)], dim=-1).reshape(
        *pts.shape[:-1], pts.shape[-1] * 2
    )
