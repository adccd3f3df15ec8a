"""Plain PyTorch reference of the FreeSplat encoder, float32 throughout.

A frozen, flattened copy of the port's encoder arithmetic: EfficientNetV2-S
backbone -> plane-sweep cost volume -> CVEncoder -> dense-grid DepthDecoder
-> per-pixel Gaussians -> PTF cross-view fusion -> Gaussian head.  NHWC
feature maps.  Module and parameter names are those of the port's
``EncoderFreeSplat``, so one state dict loads into both.

It imports nothing of the program, calls no hand-written kernel, and keeps
one path: BatchNorm always normalizes with the batch statistics (both
cells' mode), the gathers are ``index_select`` with autograd's own
backward, and the whole-scene encode runs the backbone once per chunk of
views (the program runs it twice, once for the matching features and once
for the trunk; with batch statistics per chunk the results are the same).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (block_type, kernel, stride, expand, out_ch, num_blocks, se_ratio)
EFFNETV2_S = (
    ("fused", 3, 1, 1, 24, 2, 0.0),
    ("fused", 3, 2, 4, 48, 4, 0.0),
    ("fused", 3, 2, 4, 64, 4, 0.0),
    ("mbconv", 3, 2, 4, 128, 6, 0.25),
    ("mbconv", 3, 1, 6, 160, 9, 0.25),
    ("mbconv", 3, 2, 6, 256, 15, 0.25),
)
FEATURE_STAGES = (0, 1, 2, 4, 5)
FEATURE_CHANNELS = (24, 48, 64, 160, 256)


@dataclass(frozen=True)
class EncoderSizes:
    """The sizes the reference reads, from a configuration's overrides."""

    num_depth_candidates: int
    num_views: int  # cost-volume views: nearest (num_views - 1) sources + itself
    log_planes: bool
    near: float
    far: float
    d_feature: int
    matching_dim: int
    sh_degree: int
    gaussian_scale_min: float
    gaussian_scale_max: float

    @classmethod
    def from_overrides(cls, o: dict) -> "EncoderSizes":
        return cls(
            num_depth_candidates=int(o["encoder.num_depth_candidates"]),
            num_views=int(o["encoder.num_views"]),
            log_planes=bool(o["encoder.log_planes"]),
            near=float(o["encoder.near"]),
            far=float(o["encoder.far"]),
            d_feature=int(o["encoder.d_feature"]),
            matching_dim=int(o["encoder.matching_dim"]),
            sh_degree=int(o["encoder.adapter.sh_degree"]),
            gaussian_scale_min=float(o["encoder.adapter.gaussian_scale_min"]),
            gaussian_scale_max=float(o["encoder.adapter.gaussian_scale_max"]),
        )


# ---------------------------------------------------------------- layers


def _same_pad(size, kernel: int, stride: int):
    """flax ``padding="SAME"``: the smaller half first."""
    pads = []
    for n in size:
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads.append((total // 2, total - total // 2))
    (h_lo, h_hi), (w_lo, w_hi) = pads
    return (w_lo, w_hi, h_lo, h_hi)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` over NHWC input; ``padding`` an int or ``"SAME"``."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0, groups=1, bias=True):
        self.same = padding == "SAME"
        super().__init__(in_ch, out_ch, kernel, stride, 0 if self.same else padding,
                         groups=groups, bias=bias)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if self.same:
            x = F.pad(x, _same_pad(x.shape[2:], self.kernel_size[0], self.stride[0]))
        return self._conv_forward(x, self.weight, self.bias).permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(epsilon=1e-3)`` with batch statistics, NHWC."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        y = F.batch_norm(x.permute(0, 3, 1, 2), None, None, self.weight, self.bias,
                         training=True, eps=1e-3)
        return y.permute(0, 2, 3, 1)


class BNAct(nn.Module):
    def __init__(self, ch: int, act: bool = True):
        super().__init__()
        self.bn = BatchNorm(ch)
        self.act = act

    def forward(self, x):
        x = self.bn(x)
        return F.silu(x) if self.act else x


def lrelu(x):
    return F.leaky_relu(x, negative_slope=0.2)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_ch, features, 3, stride, 1)
        self.conv2 = Conv(features, features, 3, 1, 1)
        self.downsample = None
        if in_ch != features or stride != 1:
            k, pad = (1, 0) if stride == 1 else (3, 1)
            self.downsample = Conv(in_ch, features, k, stride, pad)

    def forward(self, x):
        out = self.conv2(lrelu(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return lrelu(out + identity)


class DoubleBasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.block0 = BasicBlock(in_ch, features)
        self.block1 = BasicBlock(features, features)

    def forward(self, x):
        return self.block1(self.block0(x))


class MLP(nn.Module):
    def __init__(self, in_ch: int, channels):
        super().__init__()
        self.n = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", nn.Linear(in_ch, ch))
            in_ch = ch

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = F.leaky_relu(x, negative_slope=0.01)
        return x


def upsample2x(x):
    """Bilinear x2 of NHWC, align_corners=False, edges clamped."""

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


@functools.lru_cache(maxsize=16)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) two-tap bilinear matrix, align_corners=True."""
    pos = np.linspace(0.0, src - 1.0, dst, dtype=np.float64) if dst > 1 else np.zeros(1)
    p0 = np.clip(np.floor(pos), 0, src - 1)
    p1 = np.clip(p0 + 1, 0, src - 1)
    t = np.clip(pos - p0, 0.0, 1.0)
    m = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    m[rows, p0.astype(np.int64)] += (1.0 - t).astype(np.float32)
    m[rows, p1.astype(np.int64)] += t.astype(np.float32)
    return m


def resize_align_corners(x, out_hw):
    n, h, w, c = x.shape
    ry = torch.from_numpy(_resize_matrix(h, out_hw[0])).to(x.device)
    rx = torch.from_numpy(_resize_matrix(w, out_hw[1])).to(x.device)
    out = torch.einsum("oh,nhwc->nowc", ry, x)
    return torch.einsum("pw,nowc->nopc", rx, out)


# -------------------------------------------------------------- backbone


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced: int):
        super().__init__()
        self.reduce = Conv(ch, reduced, 1)
        self.expand = Conv(reduced, ch, 1)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        return x * torch.sigmoid(self.expand(F.silu(self.reduce(s))))


class FusedMBConv(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride, expand):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        self.expand = expand
        if expand != 1:
            mid = in_ch * expand
            self.conv_exp = Conv(in_ch, mid, kernel, stride, "SAME", bias=False)
            self.bn1 = BNAct(mid)
            self.conv_pwl = Conv(mid, out_ch, 1, bias=False)
            self.bn2 = BNAct(out_ch, act=False)
        else:
            self.conv = Conv(in_ch, out_ch, kernel, stride, "SAME", bias=False)
            self.bn1 = BNAct(out_ch)

    def forward(self, x):
        if self.expand != 1:
            y = self.bn2(self.conv_pwl(self.bn1(self.conv_exp(x))))
        else:
            y = self.bn1(self.conv(x))
        return y + x if self.residual else y


class MBConv(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride, expand, se_ratio):
        super().__init__()
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == out_ch
        self.conv_pw = Conv(in_ch, mid, 1, bias=False)
        self.bn1 = BNAct(mid)
        self.conv_dw = Conv(mid, mid, kernel, stride, "SAME", groups=mid, bias=False)
        self.bn2 = BNAct(mid)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * se_ratio))) if se_ratio > 0 else None
        self.conv_pwl = Conv(mid, out_ch, 1, bias=False)
        self.bn3 = BNAct(out_ch, act=False)

    def forward(self, x):
        y = self.bn2(self.conv_dw(self.bn1(self.conv_pw(x))))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class EfficientNetV2S(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_stem = Conv(3, 24, 3, 2, "SAME", bias=False)
        self.bn_stem = BNAct(24)
        self.blocks = []
        ch = 24
        for si, (btype, k, s, e, out_ch, n, se) in enumerate(EFFNETV2_S):
            for bi in range(n):
                stride = s if bi == 0 else 1
                block = (FusedMBConv(ch, out_ch, k, stride, e) if btype == "fused"
                         else MBConv(ch, out_ch, k, stride, e, se))
                self.add_module(f"stage{si}_block{bi}", block)
                self.blocks.append((si, bi == n - 1, f"stage{si}_block{bi}"))
                ch = out_ch

    def forward(self, x):
        x = self.bn_stem(self.conv_stem(x))
        features = []
        for si, last, name in self.blocks:
            x = getattr(self, name)(x)
            if last and si in FEATURE_STAGES:
                features.append(x)
        return features


# ----------------------------------------------------------- cost volume


def bilinear_sample(features, coords):
    """features (B, h, w, c), coords (B, n, 2) pixel xy (centers at
    half-integers) -> (B, n, c); taps outside the map weigh 0."""
    nb, h, w, c = features.shape
    x = coords[..., 0] - 0.5
    y = coords[..., 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    flat = features.reshape(nb * h * w, c)
    boff = (h * w) * torch.arange(nb, device=features.device)[:, None]

    def tap(xi, yi, weight):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = torch.where(inside, yi * w + xi, 0) + boff
        rows = flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c)
        return rows * (weight * inside)[..., None]

    return (tap(x0i, y0i, (1 - wx) * (1 - wy)) + tap(x0i + 1, y0i, wx * (1 - wy))
            + tap(x0i, y0i + 1, (1 - wx) * wy) + tap(x0i + 1, y0i + 1, wx * wy))


class CostVolume(nn.Module):
    """The average warped source feature and the view-averaged dot product,
    through a per-(pixel, plane) MLP."""

    plane_chunk_rows = 8_000_000

    def __init__(self, feat_ch: int, num_depth_bins: int):
        super().__init__()
        self.num_depth_bins = num_depth_bins
        self.mlp = MLP(feat_ch + 1, (32, 32, 1))

    def forward(self, cur, src, src_T_cur, src_K, cur_invK, min_depth, max_depth):
        b, h, w, c = cur.shape
        v = src.shape[1]
        d = self.num_depth_bins
        n = h * w
        dev = cur.device
        t = torch.linspace(0.0, 1.0, d, device=dev)
        inv = 1.0 / min_depth[:, None] + (1.0 / max_depth[:, None] - 1.0 / min_depth[:, None]) * t
        depths = 1.0 / inv  # (b, d)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                                torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                                indexing="ij")
        pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
        rays = torch.einsum("bij,nj->bni", cur_invK[:, :3, :3], pix)
        proj = torch.einsum("bvij,bvjk->bvik", src_K, src_T_cur)[:, :, :3]
        src_flat = src.reshape(b * v, h, w, c)
        cur = cur.reshape(b, 1, 1, n, c)
        step = max(1, min(d, self.plane_chunk_rows // max(b * v * n, 1)))
        out = []
        for s in range(0, d, step):
            dc = depths[:, s:s + step]
            k = dc.shape[1]
            cam = rays[:, None] * dc[:, :, None, None]
            cam_h = torch.cat([cam, torch.ones_like(cam[..., :1])], dim=-1)
            p = torch.einsum("bvij,bdnj->bvdni", proj, cam_h)
            z = p[..., 2:3]
            scale = torch.where(z.abs() > 1e-8, 1.0 / (z + 1e-8), 1.0)
            uv = (p[..., :2] * scale).detach()
            warped = bilinear_sample(src_flat, uv.reshape(b * v, k * n, 2)).reshape(b, v, k, n, c)
            mask = (z > 0).to(warped.dtype)
            dot = (warped * cur).sum(-1) * mask[..., 0]
            nonzero = (dot != 0).to(warped.dtype)
            denom = nonzero.sum(1) + 1e-8
            feat_avg = (warped * nonzero[..., None]).sum(1) / denom[..., None]
            combined = torch.cat([feat_avg, (dot.sum(1) / denom)[..., None]], dim=-1)
            out.append(self.mlp(combined)[..., 0])
        return torch.cat(out, dim=1).transpose(1, 2).reshape(b, h, w, d)


# -------------------------------------------------------------- networks


class CVEncoder(nn.Module):
    def __init__(self, in_ch: int, img_chs=FEATURE_CHANNELS[1:], outs=(64, 128, 256, 384)):
        super().__init__()
        self.n = len(outs)
        for i, ch in enumerate(outs):
            self.add_module(f"ds_conv_{i}", BasicBlock(in_ch, ch, 1 if i == 0 else 2))
            self.add_module(f"conv_{i}a", BasicBlock(ch + img_chs[i], ch))
            self.add_module(f"conv_{i}b", BasicBlock(ch, ch))
            in_ch = ch
        self.num_ch_outs = tuple(outs)

    def forward(self, x, img_feats):
        outputs = []
        for i in range(self.n):
            x = getattr(self, f"ds_conv_{i}")(x)
            x = torch.cat([x, img_feats[i]], dim=-1)
            x = getattr(self, f"conv_{i}b")(getattr(self, f"conv_{i}a")(x))
            outputs.append(x)
        return outputs


class DepthDecoder(nn.Module):
    """Dense-grid decoder; node (i, j) is scale i after column j."""

    def __init__(self, in_chs, num_output_channels, near, far, num_samples, log_planes,
                 num_ch_dec=(64, 64, 128, 256), md=4):
        super().__init__()
        self.near, self.far, self.num_samples, self.log_planes, self.md = (
            near, far, num_samples, log_planes, md)
        ch_of = {(i, 0): c for i, c in enumerate(in_chs)}
        for j in range(1, md + 1):
            for i in range(md - j, -1, -1):
                ch = num_ch_dec[i]
                self.add_module(f"right_conv_{i}{j - 1}", BasicBlock(ch_of[(i, j - 1)], ch))
                self.add_module(f"diag_conv_{i + 1}{j - 1}", BasicBlock(ch_of[(i + 1, j - 1)], ch))
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

    def forward(self, feats):
        md = self.md
        node = {(i, 0): f for i, f in enumerate(feats)}
        head = {}
        for j in range(1, md + 1):
            for i in range(md - j, -1, -1):
                ins = [getattr(self, f"right_conv_{i}{j - 1}")(node[(i, j - 1)]),
                       upsample2x(getattr(self, f"diag_conv_{i + 1}{j - 1}")(node[(i + 1, j - 1)]))]
                if i + j != md:
                    ins.append(upsample2x(getattr(self, f"up_conv_{i + 1}{j}")(node[(i + 1, j)])))
                x = getattr(self, f"in_conv_{i}{j}")(torch.cat(ins, dim=-1))
                node[(i, j)] = x
                if i + j == md:
                    hx = getattr(self, f"output_pre_{i}")(x) if i != 0 else x
                    head[i] = getattr(self, f"output_{i}")(hx)
        t = torch.linspace(0.0, 1.0, self.num_samples, device=feats[0].device)
        if self.log_planes:
            cand = math.log(self.near) + t * math.log(self.far / self.near)
        else:
            cand = (1.0 / self.near) + t * (1.0 / self.far - 1.0 / self.near)
        planes = getattr(self, "conv_depth_0b")(getattr(self, "conv_depth_0a")(head[0]))
        planes = torch.softmax(planes, dim=-1)
        disps = (planes * cand).sum(-1, keepdim=True)
        h0, w0 = disps.shape[1:3]
        fine = resize_align_corners(disps, (2 * h0, 2 * w0))
        depth = torch.exp(fine) if self.log_planes else 1.0 / fine
        out = self.conv_last_b(self.conv_last_a(upsample2x(head[0])))
        weights = resize_align_corners(planes, (2 * h0, 2 * w0)).amax(-1, keepdim=True)
        return depth, out, weights


class GRU(nn.Module):
    def __init__(self, hc: int = 64, emb: int = 24):
        super().__init__()
        for name, d_in in (("mlp_r", 2 * (hc + emb)), ("mlp_z", 2 * (hc + emb)),
                           ("mlp_n", hc + hc + emb)):
            self.add_module(f"{name}_0", nn.Linear(d_in, hc))
            self.add_module(f"{name}_1", nn.Linear(hc, hc))

    def _mlp(self, name, x):
        return getattr(self, f"{name}_1")(F.relu(getattr(self, f"{name}_0")(x)))

    def forward(self, input_feat, hidden_feat, input_emb, hidden_emb):
        input_1 = torch.cat([input_feat, input_emb], dim=-1)
        concat = torch.cat([hidden_feat, hidden_emb, input_1], dim=-1)
        r = torch.sigmoid(self._mlp("mlp_r", concat))
        z = torch.sigmoid(self._mlp("mlp_z", concat))
        q = torch.tanh(self._mlp("mlp_n", torch.cat([r * hidden_feat, input_1], dim=-1)))
        return (1.0 - z) * hidden_feat + z * q


def positional_encoding(x, freqs: int):
    """(..., D) -> (..., 2 D freqs): per input dim its freqs, sin then cos."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.stack([torch.sin(pts), torch.cos(pts)], dim=-1).reshape(
        *pts.shape[:-1], pts.shape[-1] * 2)


# -------------------------------------------------------------- geometry


def sweep_geometry(extr, intr, num_views: int, match_hw):
    """Per scene: source indices (v, s), cur->src transforms, source pixel
    intrinsics at matching resolution (v, s, 4, 4), inverse current
    intrinsics (v, 4, 4).  Sources: the nearest views by translation +
    rotation angle, the lower index first among ties."""
    v = extr.shape[0]
    mh, mw = match_hw
    num_src = min(num_views, v) - 1
    if v > num_views:
        t = extr[:, :3, 3]
        r = extr[:, :3, :3]
        tdist = torch.linalg.norm(t[:, None] - t[None, :], dim=-1)
        trace = (r[:, None].transpose(-1, -2) @ r[None, :]).diagonal(dim1=-2, dim2=-1).sum(-1)
        dist = tdist + torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
        dist = dist + torch.eye(v, device=extr.device) * 1e9
        src_idx = torch.sort(dist, dim=-1, stable=True).indices[:, :num_src]
    else:
        allv = torch.arange(v, device=extr.device)
        src_idx = torch.stack([torch.cat([allv[:i], allv[i + 1:]]) for i in range(v)])
    k_pix = intr.clone()
    k_pix[:, 0] = k_pix[:, 0] * mw
    k_pix[:, 1] = k_pix[:, 1] * mh
    k44 = torch.eye(4, device=extr.device, dtype=extr.dtype).repeat(v, 1, 1)
    k44[:, :3, :3] = k_pix
    w2c = torch.linalg.inv(extr)
    src_T_cur = torch.einsum("vsij,vjk->vsik", w2c[src_idx], extr)
    return src_idx, src_T_cur, k44[src_idx], torch.linalg.inv(k44)


def unproject_depth(depths, intrinsics, extrinsics, image_shape):
    """(v, h, w) depths -> (v, h, w, 3) world points at integer pixel corners."""
    h, w = image_shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=depths.device),
                            torch.arange(w, dtype=torch.float32, device=depths.device),
                            indexing="ij")
    fx, fy = intrinsics[:, 0, 0] * w, intrinsics[:, 1, 1] * h
    cx, cy = intrinsics[:, 0, 2] * w, intrinsics[:, 1, 2] * h
    x = (xs - cx[:, None, None]) / fx[:, None, None] * depths
    y = (ys - cy[:, None, None]) / fy[:, None, None] * depths
    cam = torch.stack([x, y, depths], dim=-1)
    return (torch.einsum("vij,vhwj->vhwi", extrinsics[:, :3, :3], cam)
            + extrinsics[:, None, None, :3, 3])


def quaternion_to_matrix(q, eps: float = 1e-8):
    """(..., 4) xyzw -> (..., 3, 3)."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / ((q * q).sum(-1) + eps)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(*o.shape[:-1], 3, 3)


def build_covariance(scale, quat):
    rs = quaternion_to_matrix(quat) * scale[..., None, :]
    return rs @ rs.transpose(-1, -2)


# -------------------------------------------------------------------- PTF


def _project(coords, extrinsic, intrinsic, image_shape):
    h, w = image_shape
    w2c = torch.linalg.inv(extrinsic)
    cam = coords @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    u = cam[:, 0] / z * (intrinsic[0, 0] * w) + intrinsic[0, 2] * w
    v = cam[:, 1] / z * (intrinsic[1, 1] * h) + intrinsic[1, 2] * h
    ui = torch.nan_to_num(torch.round(u), nan=-1.0, posinf=-1.0, neginf=-1.0)
    vi = torch.nan_to_num(torch.round(v), nan=-1.0, posinf=-1.0, neginf=-1.0)
    ok = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (z > 0)
    return torch.where(ok, vi.long() * w + ui.long(), h * w), z, ok


def _pack(feat, density, weight, coords, depth, extr16):
    return torch.cat([feat, density, weight, coords, depth[:, None], extr16], dim=-1)


def fuse_views(feats, coords, dens, wts, depths, extr, intr, image_shape, gru,
               depth_thres: float = 0.1, pe_freqs: int = 6):
    """Pixel-wise triplet fusion over a slot buffer of V*H*W Gaussians.

    Per new view: project every valid slot, keep the nearest per pixel (the
    largest slot index among exact ties), merge the pixels whose predicted
    depth agrees with it (|dz| < max(5 % d, 0.1)) through the GRU and
    density-weighted averages, and let the others claim their own slots.
    Returns (packed (G, c + 22), valid (G,)): columns feat c | density |
    weight | coords 3 | depth | extrinsics 16."""
    v, hw, c = feats.shape
    dev = feats.device
    packed = _pack(feats[0], dens[0], wts[0], coords[0], depths[0],
                   extr[0].reshape(1, 16).expand(hw, 16))
    valid = torch.ones(hw, dtype=torch.bool, device=dev)
    for i in range(1, v):
        g = packed.shape[0]
        pix, z, ok = _project(packed[:, c + 2:c + 5], extr[i], intr[i], image_shape)
        ok = ok & valid
        slot = torch.arange(g, device=dev)
        target = torch.where(ok, pix, hw)  # hw: a bin no pixel reads
        zmin = torch.full((hw + 1,), torch.inf, device=dev).scatter_reduce(
            0, target, torch.where(ok, z, torch.inf), "amin")[:hw]
        win = ok & (z == zmin[torch.clamp(pix, 0, hw - 1)])
        winner = torch.full((hw + 1,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, torch.where(win, pix, hw), torch.where(win, slot, -1), "amax")[:hw]
        zbuf = torch.where(torch.isfinite(zmin), zmin, 1e4)
        fusion = (zbuf - depths[i]).abs() < torch.clamp(depths[i] * 0.05, min=depth_thres)
        matched = fusion & (winner >= 0)
        gathered = packed.index_select(0, torch.where(matched, winner, 0))
        g_feat, g_dens, g_wt = gathered[:, :c], gathered[:, c:c + 1], gathered[:, c + 1:c + 2]
        g_coords, g_depth = gathered[:, c + 2:c + 5], gathered[:, c + 5]
        g_extr = gathered[:, c + 6:c + 22].reshape(-1, 4, 4)
        in_emb = positional_encoding(torch.cat([g_dens, wts[i]], dim=-1), pe_freqs)
        hid_emb = positional_encoding(torch.cat([dens[i], g_wt], dim=-1), pe_freqs)
        fused_feat = gru(feats[i], g_feat, in_emb, hid_emb)
        denom = g_dens + dens[i]
        fused = _pack(
            fused_feat, g_dens + dens[i], g_wt + wts[i],
            (g_coords * g_dens + coords[i] * dens[i]) / denom,
            (g_depth * g_dens[:, 0] + depths[i] * dens[i][:, 0]) / denom[:, 0],
            ((g_extr * g_dens[..., None] + extr[i][None] * dens[i][..., None])
             / denom[..., None]).reshape(-1, 16))
        packed = packed.index_put((winner[matched],), fused[matched])
        own = _pack(feats[i], dens[i], wts[i], coords[i], depths[i],
                    extr[i].reshape(1, 16).expand(hw, 16))
        packed = torch.cat([packed, torch.where(~fusion[:, None], own, 0.0)])
        valid = torch.cat([valid, ~fusion])
    return packed, valid


# ---------------------------------------------------------------- encoder


class FuseScene(nn.Module):
    def __init__(self, d_feature: int, d_in: int):
        super().__init__()
        self.gru = GRU(d_feature)
        self.to_gaussians = nn.Linear(d_feature, 2 + d_in)


class Encoder(nn.Module):
    """``encode(context, view_chunk)`` -> dict of Gaussians (means (g, 3),
    covariances (g, 3, 3), harmonics (g, 3, d_sh), opacities (g,), mask
    (g,)), ``depth`` (v, h, w) and ``num_gaussians``, for one scene."""

    def __init__(self, sizes: EncoderSizes):
        super().__init__()
        self.sizes = s = sizes
        d = s.num_depth_candidates
        self.d_sh = (s.sh_degree + 1) ** 2
        self.backbone = EfficientNetV2S()
        if FEATURE_CHANNELS[1] != s.matching_dim:
            self.match_proj = Conv(FEATURE_CHANNELS[1], s.matching_dim, 1)
        self.cost_volume = CostVolume(s.matching_dim, d)
        self.cv_encoder = CVEncoder(d)
        self.depth_decoder = DepthDecoder(
            (FEATURE_CHANNELS[0], *self.cv_encoder.num_ch_outs), 1 + s.d_feature,
            s.near, s.far, d, s.log_planes)
        self.hr_skip = Conv(3, s.d_feature, 7, 1, 3)
        self.fuse = FuseScene(s.d_feature, 7 + 3 * self.d_sh)

    def encode(self, context: dict, view_chunk: int | None = None) -> dict:
        s = self.sizes
        images = context["image"][0]  # (v, h, w, 3)
        extr, intr = context["extrinsics"][0], context["intrinsics"][0]
        near, far = context["near"][0, 0], context["far"][0, 0]
        v, h, w, _ = images.shape
        chunks = [slice(a, min(a + (view_chunk or v), v)) for a in range(0, v, view_chunk or v)]
        feats = [self.backbone(images[sl]) for sl in chunks]
        match = torch.cat([f[1] for f in feats])
        if hasattr(self, "match_proj"):
            match = self.match_proj(match)
        mh, mw = match.shape[1:3]
        src_idx, src_T_cur, src_K, cur_invK = sweep_geometry(extr, intr, s.num_views, (mh, mw))
        depth, out, wt = [], [], []
        for sl, f in zip(chunks, feats):
            n = sl.stop - sl.start
            volume = self.cost_volume(
                match[sl], match[src_idx[sl]], src_T_cur[sl], src_K[sl], cur_invK[sl],
                near.expand(n), far.expand(n))
            dd, oo, ww = self.depth_decoder([f[0]] + self.cv_encoder(volume, f[1:]))
            depth.append(dd[..., 0])
            out.append((oo[..., 1:] + F.relu(self.hr_skip(images[sl])), torch.sigmoid(oo[..., :1])))
            wt.append(ww)
        depth = torch.cat(depth)  # (v, h, w)
        feat = torch.cat([o[0] for o in out]).reshape(v, h * w, s.d_feature)
        dens = torch.cat([o[1] for o in out]).reshape(v, h * w, 1)
        wt = torch.cat(wt).reshape(v, h * w, 1)
        means = unproject_depth(depth, intr, extr, (h, w)).reshape(v, h * w, 3)
        packed, valid = fuse_views(feat, means, dens, wt, depth.reshape(v, h * w), extr, intr,
                                   (h, w), self.fuse.gru)
        c = s.d_feature
        raw = self.fuse.to_gaussians(F.relu(packed[:, :c]))
        opac = torch.sigmoid(raw[:, 0])
        raw = raw[:, 2:]
        g_depth = packed[:, c + 5]
        rot_c2w = packed[:, c + 6:c + 22].reshape(-1, 4, 4)[:, :3, :3]
        scales = s.gaussian_scale_min + (s.gaussian_scale_max - s.gaussian_scale_min) * (
            1.0 / (1.0 + torch.exp(-raw[:, 0:3])))
        pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32, device=images.device)
        multiplier = (0.1 * (torch.linalg.inv(intr[0, :2, :2]) @ pixel_size)).sum()
        scales = scales * g_depth[:, None] * multiplier
        quat = raw[:, 3:7]
        quat = quat / torch.sqrt((quat * quat).sum(-1, keepdim=True) + 1e-12)
        sh_mask = torch.ones(self.d_sh, device=images.device)
        for deg in range(1, s.sh_degree + 1):
            sh_mask[deg ** 2:(deg + 1) ** 2] = 0.1 * 0.25 ** deg
        sh = raw[:, 7:].reshape(-1, 3, self.d_sh) * sh_mask
        cov = rot_c2w @ build_covariance(scales, quat) @ rot_c2w.transpose(-1, -2)
        return {
            "means": packed[:, c + 2:c + 5], "covariances": cov, "harmonics": sh,
            "opacities": torch.where(valid, opac, 0.0), "mask": valid,
            "depth": depth, "num_gaussians": valid.sum(),
        }
