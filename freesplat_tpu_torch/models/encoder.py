"""FreeSplat encoder: posed context images -> fused 3D Gaussians.

Port of ``freesplat_tpu/models/encoder.py`` (``stage="full"``): backbone
-> plane-sweep cost volume -> CVEncoder -> dense-grid DepthDecoder ->
per-pixel Gaussians -> PTF cross-view fusion -> Gaussian head.  NHWC
throughout; the JAX ``nn.vmap``s over scenes become a batch dimension
(cost volume) and a loop over scenes (PTF).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .adapter import GaussianAdapterCfg, build_gaussians, unproject_depth
from .backbone import FEATURE_CHANNELS, EfficientNetV2S
from .cost_volume import CostVolume
from .layers import Conv
from .networks import GRU, CVEncoder, DepthDecoder
from .ptf import fuse_views
from .types import Gaussians


@dataclass(frozen=True)
class EncoderFreeSplatCfg:
    num_depth_candidates: int = 128
    num_views: int = 2  # max source views + 1 for the cost volume
    log_planes: bool = True
    d_feature: int = 64
    num_surfaces: int = 1
    near: float = 0.5
    far: float = 15.0
    matching_dim: int = 48
    adapter: GaussianAdapterCfg = field(default_factory=GaussianAdapterCfg)
    train_bn: bool = True  # BN with batch statistics at every forward


def pose_distance_matrix(extrinsics: torch.Tensor) -> torch.Tensor:
    """Translation + rotation-angle distance between all view pairs."""
    t = extrinsics[..., :3, 3]
    r = extrinsics[..., :3, :3]
    tdist = torch.linalg.norm(t[:, None] - t[None, :], dim=-1)
    rrel = r[:, None].transpose(-1, -2) @ r[None, :]
    trace = rrel.diagonal(dim1=-2, dim2=-1).sum(-1)
    angle = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    return tdist + angle


def select_source_views(extrinsics: torch.Tensor, num_src: int) -> torch.Tensor:
    """(v, v) pose distances -> (v, num_src) nearest other-view indices,
    the lower index first among equal distances (as ``jax.lax.top_k``
    orders ties; ``torch.topk`` makes no promise there)."""
    v = extrinsics.shape[0]
    dist = pose_distance_matrix(extrinsics)
    dist = dist + torch.eye(v, device=extrinsics.device) * 1e9  # exclude self
    return torch.sort(dist, dim=-1, stable=True).indices[:, :num_src]


def sweep_geometry(extr, intr, num_views: int, match_hw: tuple[int, int]):
    """Per scene: source indices (v, s), cur->src transforms (v, s, 4, 4),
    source pixel intrinsics at matching resolution (v, s, 4, 4) and the
    inverse current intrinsics (v, 4, 4)."""
    v = extr.shape[0]
    mh, mw = match_hw
    num_src = min(num_views, v) - 1
    if v > num_views:
        src_idx = select_source_views(extr, num_src)
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


class FuseScene(nn.Module):
    """Per-scene PTF fusion + Gaussian head (the JAX ``_FuseScene``)."""

    def __init__(self, cfg: EncoderFreeSplatCfg):
        super().__init__()
        self.cfg = cfg
        self.gru = GRU(hidden_channel=cfg.d_feature)
        self.to_gaussians = nn.Linear(cfg.d_feature, cfg.num_surfaces * (2 + cfg.adapter.d_in))

    def forward(self, feat, coords, dens, wt, depth, extr, intr, image_shape):
        state = fuse_views(feat, coords, dens, wt, depth, extr, intr, image_shape, self.gru)
        raw = self.to_gaussians(F.relu(state.feat))
        opacities = torch.sigmoid(raw[..., 0])
        params = build_gaussians(
            self.cfg.adapter, raw[..., 2:], state.depth,
            state.extrinsics[:, :3, :3], intr[0], image_shape,
        )
        gaussians = Gaussians(
            means=state.coords,
            covariances=params["covariances"],
            harmonics=params["harmonics"],
            opacities=torch.where(state.valid, opacities, 0.0),
            mask=state.valid,
        )
        return gaussians, params["scales"], params["rotations"]


class EncoderFreeSplat(nn.Module):
    def __init__(self, cfg: EncoderFreeSplatCfg = EncoderFreeSplatCfg()):
        super().__init__()
        self.cfg = cfg
        d = cfg.num_depth_candidates
        self.backbone = EfficientNetV2S(train_bn=cfg.train_bn)
        if FEATURE_CHANNELS[1] != cfg.matching_dim:
            self.match_proj = Conv(FEATURE_CHANNELS[1], cfg.matching_dim, 1)
        self.cost_volume = CostVolume(cfg.matching_dim, num_depth_bins=d)
        self.cv_encoder = CVEncoder(in_ch=d)
        self.depth_decoder = DepthDecoder(
            in_chs=(FEATURE_CHANNELS[0], *self.cv_encoder.num_ch_outs),
            num_output_channels=1 + cfg.d_feature, near=cfg.near, far=cfg.far,
            num_samples=d, log_planes=cfg.log_planes,
        )
        self.hr_skip = Conv(3, cfg.d_feature, 7, 1, 3)
        self.fuse = FuseScene(cfg)

    def trunk(self, context: dict[str, torch.Tensor]) -> dict[str, Any]:
        """Backbone -> cost volume -> CVEncoder -> DepthDecoder -> hr_skip:
        the per-view PTF inputs (the JAX ``trunk_only`` output dict)."""
        cfg = self.cfg
        images = context["image"]
        extr, intr = context["extrinsics"], context["intrinsics"]
        b, v, h, w, _ = images.shape
        if h % 32 or w % 32:
            raise ValueError(f"image shape ({h}, {w}) must be divisible by 32")
        hw = h * w

        flat = images.reshape(b * v, h, w, 3)
        feats = self.backbone(flat)
        match_feats = feats[1]
        if hasattr(self, "match_proj"):
            match_feats = self.match_proj(match_feats)
        mh, mw = match_feats.shape[1:3]
        match_bv = match_feats.reshape(b, v, mh, mw, -1)

        geo = [sweep_geometry(extr[i], intr[i], cfg.num_views, (mh, mw)) for i in range(b)]
        src_idx, src_T_cur, src_K, cur_invK = (torch.stack(x) for x in zip(*geo))
        match_src = torch.stack([match_bv[i][src_idx[i]] for i in range(b)])
        ns = src_idx.shape[-1]
        cost_volume = self.cost_volume(
            match_bv.reshape(b * v, mh, mw, -1),
            match_src.reshape(b * v, ns, mh, mw, -1),
            src_T_cur.reshape(b * v, ns, 4, 4),
            src_K.reshape(b * v, ns, 4, 4),
            cur_invK.reshape(b * v, 4, 4),
            context["near"][:, :1].expand(b, v).reshape(-1),
            context["far"][:, :1].expand(b, v).reshape(-1),
        )  # (b*v, mh, mw, D)

        cv_feats = self.cv_encoder(cost_volume, feats[1:])
        outputs = self.depth_decoder([feats[0]] + cv_feats)

        skip = F.relu(self.hr_skip(flat))
        gauss_feats = outputs["output_s-1"][..., 1:] + skip
        densities = torch.sigmoid(outputs["output_s-1"][..., :1])
        depths = outputs["depth_s-1"][..., 0]
        weights = outputs["depth_weights"]
        means = unproject_depth(depths.reshape(b, v, h, w), intr, extr, (h, w))
        return {
            "feat_v": gauss_feats.reshape(b, v, hw, cfg.d_feature),
            "coords_v": means.reshape(b, v, hw, 3),
            "dens_v": densities.reshape(b, v, hw, 1),
            "wt_v": weights.reshape(b, v, hw, 1),
            "depth_v": depths.reshape(b, v, hw),
            "depth_s-1": depths.reshape(b, v, h, w),
            "densities": densities.reshape(b, v, h, w),
            "depth_weights": weights.reshape(b, v, h, w),
            **{
                f"depth_s{s}": outputs[f"depth_s{s}"].reshape(
                    b, v, *outputs[f"depth_s{s}"].shape[1:3]
                )
                for s in range(4)
            },
        }

    def forward(self, context: dict[str, torch.Tensor]) -> dict[str, Any]:
        """context: image (b, v, h, w, 3) in [0, 1]; intrinsics (b, v, 3, 3)
        normalized; extrinsics (b, v, 4, 4) c2w; near/far (b, v)."""
        trunk = self.trunk(context)
        extr, intr = context["extrinsics"], context["intrinsics"]
        b, v, h, w, _ = context["image"].shape
        per_scene = [
            self.fuse(trunk["feat_v"][i], trunk["coords_v"][i], trunk["dens_v"][i],
                      trunk["wt_v"][i], trunk["depth_v"][i], extr[i], intr[i], (h, w))
            for i in range(b)
        ]
        gaussians = Gaussians(*(torch.stack(x) for x in zip(*(p[0] for p in per_scene))))
        num_valid = gaussians.mask.sum(-1)
        results: dict[str, Any] = {
            "gaussians": gaussians,
            "visualizations": {
                "scales": torch.stack([p[1] for p in per_scene]),
                "rotations": torch.stack([p[2] for p in per_scene]),
            },
            "num_gaussians": num_valid,
            "gs_ratio": num_valid / (v * h * w),
        }
        for k in ("depth_s-1", "densities", "depth_weights", *(f"depth_s{s}" for s in range(4))):
            results[k] = trunk[k]
        return results


@torch.no_grad()
def init_like_flax(module: nn.Module, seed: int) -> nn.Module:
    """Initialize as flax's defaults do, from ``seed``: conv and dense
    kernels lecun-normal (truncated normal, variance 1/fan_in), biases 0,
    BN scale 1 / bias 0 / mean 0 / var 1."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    # std of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / trunc_std
            wt = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(wt, 0.0, std, -2 * std, 2 * std, generator=gen)
            m.weight.copy_(wt)
            if m.bias is not None:
                m.bias.zero_()
    return module


def make_encoder(
    cfg: EncoderFreeSplatCfg, device: str | torch.device = "cuda", seed: int = 0,
    train: bool = False,
) -> EncoderFreeSplat:
    """The encoder on ``device`` (default the GPU; raises without one),
    with weights initialized from ``seed``.  ``train=False`` (serving):
    ``eval()`` mode, BN buffers never touched.  ``train=True``: ``train()``
    mode, so batch-statistics BN also updates its running buffers."""
    device = resolve_device(device)
    return init_like_flax(EncoderFreeSplat(cfg), seed).to(device).train(train)
