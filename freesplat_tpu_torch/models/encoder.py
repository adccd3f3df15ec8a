"""FreeSplat encoder: posed context images -> fused 3D Gaussians.

Port of ``freesplat_tpu/models/encoder.py``: backbone -> plane-sweep cost
volume -> CVEncoder -> dense-grid DepthDecoder -> per-pixel Gaussians ->
PTF cross-view fusion -> Gaussian head.  NHWC throughout; the JAX
``nn.vmap``s over scenes become a batch dimension (cost volume) and a loop
over scenes (PTF).  ``forward(context, stage)`` has the JAX stages
("full", "match", "trunk_chunk") that the whole-scene encode
(``evaluation/harness.py::make_chunked_encode``) composes, and
``cfg.trunk_only``.  ``cfg.compute_dtype="bfloat16"`` runs the backbone,
cost-volume head, CVEncoder and DepthDecoder in bfloat16 as the flax
modules' ``dtype`` does; ``hr_skip``, PTF, the Gaussian head, the adapter
and the rasterizer stay float32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.jax_random import lecun_normal, param_key, prng_key
from ..utils.profiling import span, synced_inside
from .adapter import GaussianAdapterCfg, build_gaussians, unproject_depth
from .backbone import FEATURE_CHANNELS, EfficientNetV2S
from .cost_volume import CostVolume
from .layers import Conv, cast_at_use, compute_dtype_of
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
    compute_dtype: str = "float32"  # "bfloat16": the trunk on the tensor cores
    # Return the per-view trunk outputs from ``forward``, without the PTF
    # fuse and the Gaussian head.
    trunk_only: bool = False


@dataclass
class OpacityMappingCfg:
    initial: float = 0.0
    final: float = 0.0
    warm_up: int = 1


def map_pdf_to_opacity(
    pdf: torch.Tensor, global_step: int, cfg: OpacityMappingCfg | None = None
) -> torch.Tensor:
    """Probability density -> opacity with a warm-up-scheduled exponent
    (reference ``encoder_freesplat.py:181-194``; its runtime path takes
    opacities from sigmoid densities instead).  The identity at the
    default cfg's exponent 1."""
    cfg = cfg or OpacityMappingCfg()
    x = cfg.initial + min(global_step / cfg.warm_up, 1.0) * (cfg.final - cfg.initial)
    exponent = 2.0**x
    return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))


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
    synced_inside("encoder.sweep_geometry", 2)
    return src_idx, src_T_cur, k44[src_idx], torch.linalg.inv(k44)


class FuseScene(nn.Module):
    """Per-scene PTF fusion + Gaussian head (the JAX ``_FuseScene``)."""

    def __init__(self, cfg: EncoderFreeSplatCfg):
        super().__init__()
        self.cfg = cfg
        self.gru = GRU(hidden_channel=cfg.d_feature)
        self.to_gaussians = nn.Linear(cfg.d_feature, cfg.num_surfaces * (2 + cfg.adapter.d_in))

    def forward(self, feat, coords, dens, wt, depth, extr, intr, image_shape):
        with span("encoder.ptf"):
            state = fuse_views(feat, coords, dens, wt, depth, extr, intr, image_shape, self.gru)
        return self.head(state, intr[0], image_shape)

    def head(self, state, intr0, image_shape):
        """Fused buffer -> (Gaussians of every slot, scales, rotations)."""
        with span("encoder.head"):
            raw = self.to_gaussians(F.relu(state.feat))
            opacities = torch.sigmoid(raw[..., 0])
            params = build_gaussians(
                self.cfg.adapter, raw[..., 2:], state.depth,
                state.extrinsics[:, :3, :3], intr0, image_shape,
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
        dtype = compute_dtype_of(cfg.compute_dtype)
        self.backbone = EfficientNetV2S(train_bn=cfg.train_bn, compute_dtype=dtype)
        if FEATURE_CHANNELS[1] != cfg.matching_dim:
            self.match_proj = cast_at_use(Conv(FEATURE_CHANNELS[1], cfg.matching_dim, 1), dtype)
        self.cost_volume = CostVolume(cfg.matching_dim, num_depth_bins=d, dtype=dtype)
        self.cv_encoder = CVEncoder(in_ch=d, compute_dtype=dtype)
        self.depth_decoder = DepthDecoder(
            in_chs=(FEATURE_CHANNELS[0], *self.cv_encoder.num_ch_outs),
            num_output_channels=1 + cfg.d_feature, near=cfg.near, far=cfg.far,
            num_samples=d, log_planes=cfg.log_planes, compute_dtype=dtype,
        )
        self.hr_skip = Conv(3, cfg.d_feature, 7, 1, 3)
        self.fuse = FuseScene(cfg)

    def _features(self, images: torch.Tensor):
        """(backbone feature maps of every view, matching features
        (b, v, mh, mw, matching_dim))."""
        b, v, h, w, _ = images.shape
        if h % 32 or w % 32:
            raise ValueError(f"image shape ({h}, {w}) must be divisible by 32")
        with span("encoder.backbone"):
            feats = self.backbone(images.reshape(b * v, h, w, 3))
            match_feats = feats[1]
            if hasattr(self, "match_proj"):
                match_feats = self.match_proj(match_feats)
            return feats, match_feats.reshape(b, v, *match_feats.shape[1:])

    def trunk(self, context: dict[str, torch.Tensor], stage: str = "full") -> dict[str, Any]:
        """Backbone -> cost volume -> CVEncoder -> DepthDecoder -> hr_skip:
        the per-view PTF inputs (the JAX ``trunk_only`` output dict).
        ``stage="trunk_chunk"`` takes the source geometry and features
        from ``context`` ("match_src" (b, v, s, mh, mw, c), "src_T_cur",
        "src_K", "cur_invK"), computed over a whole trajectory, instead of
        selecting sources among these views."""
        cfg = self.cfg
        images = context["image"]
        extr, intr = context["extrinsics"], context["intrinsics"]
        b, v, h, w, _ = images.shape
        hw = h * w

        flat = images.reshape(b * v, h, w, 3)
        feats, match_bv = self._features(images)
        mh, mw = match_bv.shape[2:4]

        with span("encoder.cost_volume"):
            if stage == "trunk_chunk":
                match_src = context["match_src"]
                src_T_cur, src_K, cur_invK = (context[k]
                                              for k in ("src_T_cur", "src_K", "cur_invK"))
            else:
                geo = [sweep_geometry(extr[i], intr[i], cfg.num_views, (mh, mw))
                       for i in range(b)]
                src_idx, src_T_cur, src_K, cur_invK = (torch.stack(x) for x in zip(*geo))
                match_src = torch.stack([match_bv[i][src_idx[i]] for i in range(b)])
            ns = src_T_cur.shape[2]
            cost_volume = self.cost_volume(
                match_bv.reshape(b * v, mh, mw, -1),
                match_src.reshape(b * v, ns, mh, mw, -1),
                src_T_cur.reshape(b * v, ns, 4, 4),
                src_K.reshape(b * v, ns, 4, 4),
                cur_invK.reshape(b * v, 4, 4),
                context["near"][:, :1].expand(b, v).reshape(-1),
                context["far"][:, :1].expand(b, v).reshape(-1),
            )  # (b*v, mh, mw, D)

        with span("encoder.depth_net"):
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

    def forward(self, context: dict[str, torch.Tensor], stage: str = "full") -> dict[str, Any]:
        """context: image (b, v, h, w, 3) in [0, 1]; intrinsics (b, v, 3, 3)
        normalized; extrinsics (b, v, 4, 4) c2w; near/far (b, v).

        ``stage``: "full" the Gaussians, depths and counts; "match" only
        {"match": (b, v, mh, mw, matching_dim)}, the plane-sweep matching
        features; "trunk_chunk" the trunk dict of these views, with the
        source geometry and features from ``context`` (see ``trunk``).
        ``cfg.trunk_only`` returns the trunk dict at "full"."""
        if stage == "match":
            return {"match": self._features(context["image"])[1]}
        if stage not in ("full", "trunk_chunk"):
            raise ValueError(f"unknown stage {stage!r}")
        trunk = self.trunk(context, stage)
        if self.cfg.trunk_only or stage == "trunk_chunk":
            return trunk
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
    """Initialize as flax's defaults do at ``jax.random.PRNGKey(seed)``,
    with ``module`` as the root: conv and dense kernels lecun-normal from
    the key flax hands each (``utils/jax_random.py``), biases 0, BN scale
    1 / bias 0 / mean 0 / var 1.  The JAX package's weights for the same
    module and seed, but for the last bits of ~1 % of them."""
    root = prng_key(seed)
    for path, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            wt = m.weight
            conv = wt.ndim == 4
            shape = (wt.shape[2], wt.shape[3], wt.shape[1], wt.shape[0]) if conv else wt.shape[::-1]
            kernel = lecun_normal(param_key(root, tuple(path.split("."))), tuple(shape),
                                  fan_in=wt[0].numel())
            wt.copy_(kernel.permute(3, 2, 0, 1) if conv else kernel.T)
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
