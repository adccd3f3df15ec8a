"""Typed configuration with experiment presets and dotted overrides.

Port of ``freesplat_tpu/config/config.py``: the same dataclasses, presets
(``EXPERIMENTS``) and ``a.b.c=value`` override syntax.  The port owns its
config classes (the JAX module imports the flax models).
"""
from __future__ import annotations

import typing
from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import Any, Optional

from ..models.adapter import GaussianAdapterCfg
from ..models.decoder import DecoderCfg
from ..models.encoder import EncoderFreeSplatCfg


@dataclass(frozen=True)
class LossMseCfg:
    weight: float = 1.0


@dataclass(frozen=True)
class LossLpipsCfg:
    weight: float = 0.05
    apply_after_step: int = 0
    weights_path: Optional[str] = None


@dataclass(frozen=True)
class LossDepthCfg:
    ms_gradient_weight: float = 0.0
    scale_invariant_weight: float = 0.0
    normals_weight: float = 0.0
    mv_consistency_weight: float = 0.0


@dataclass(frozen=True)
class LossCfg:
    mse: Optional[LossMseCfg] = LossMseCfg()
    lpips: Optional[LossLpipsCfg] = LossLpipsCfg()
    depth: Optional[LossDepthCfg] = LossDepthCfg()


@dataclass(frozen=True)
class OptimizerCfg:
    lr: float = 1e-4
    warm_up_steps: int = 100
    cosine_lr: bool = True
    max_steps: int = 300_001
    gradient_clip_val: float = 0.01


@dataclass(frozen=True)
class DatasetCfg:
    name: str = "scannet"
    roots: tuple[str, ...] = ("datasets/scannet",)
    image_shape: tuple[int, int] = (384, 512)
    near: float = 0.5
    far: float = 15.0
    load_depth: bool = True
    overfit_to_scene: Optional[str] = None
    view_sampler: str = "bounded"
    num_context_views: int = 2
    evaluation_index_path: str = "assets/evaluation_index_scannet_2views.json"
    fvt_random_contexts: bool = False
    synthetic_cache_batches: int = 0
    synthetic_vary_scene: bool = False
    synthetic_num_targets: int = 2
    synthetic_renderer: str = "reference"


@dataclass(frozen=True)
class DataLoaderCfg:
    batch_size: int = 1
    seed: int = 1234


@dataclass(frozen=True)
class CheckpointingCfg:
    load: Optional[str] = None
    every_n_train_steps: int = 10_000
    output_dir: str = "outputs/checkpoints"
    strict: bool = True


@dataclass(frozen=True)
class TrainerCfg:
    max_steps: int = 300_001
    val_check_interval: int = 5000
    log_every: int = 10
    devices: str = "auto"
    val_save_video: bool = False
    val_save_projections: bool = False


@dataclass(frozen=True)
class TestCfg:
    output_path: str = "outputs/test"
    eval_depth: bool = True
    render_chunk_size: int = 50  # target views per render call
    save_depth: bool = True
    save_ply: bool = False
    save_video: bool = False
    max_scenes: Optional[int] = None
    view_shard: bool = False
    encode_view_chunk: Optional[int] = None
    render_capacity_factor: Optional[float] = None
    # True: BN normalizes with batch statistics at test time (the
    # reference's behavior); False: running averages.
    bn_batch_stats: bool = True


@dataclass(frozen=True)
class RootCfg:
    mode: str = "train"  # train | test
    seed: int = 111123
    dataset: DatasetCfg = field(default_factory=DatasetCfg)
    data_loader: DataLoaderCfg = field(default_factory=DataLoaderCfg)
    encoder: EncoderFreeSplatCfg = field(default_factory=EncoderFreeSplatCfg)
    decoder: DecoderCfg = field(default_factory=DecoderCfg)
    loss: LossCfg = field(default_factory=LossCfg)
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    checkpointing: CheckpointingCfg = field(default_factory=CheckpointingCfg)
    trainer: TrainerCfg = field(default_factory=TrainerCfg)
    test: TestCfg = field(default_factory=TestCfg)


def _scannet(views: int, fvt: bool = False) -> RootCfg:
    return RootCfg(
        dataset=DatasetCfg(
            name="scannet",
            image_shape=(384, 512),
            near=0.5,
            far=15.0,
            num_context_views=views,
            fvt_random_contexts=fvt,
            evaluation_index_path=f"assets/evaluation_index_scannet_{views}views.json",
        ),
        encoder=EncoderFreeSplatCfg(
            # FVT caps cost-volume source selection at 5 views.
            num_views=5 if fvt else views,
            num_depth_candidates=128,
            log_planes=True,
            near=0.5,
            far=15.0,
            adapter=GaussianAdapterCfg(sh_degree=2),
        ),
        loss=LossCfg(
            mse=LossMseCfg(weight=1.0),
            lpips=LossLpipsCfg(weight=0.05, apply_after_step=0),
        ),
        optimizer=OptimizerCfg(
            lr=1e-4, warm_up_steps=100, cosine_lr=True,
            max_steps=300_001, gradient_clip_val=0.01,
        ),
        trainer=TrainerCfg(max_steps=300_001),
    )


def _re10k() -> RootCfg:
    base = _scannet(2)
    return replace(
        base,
        dataset=replace(
            base.dataset, name="re10k", image_shape=(256, 256), near=1.0, far=100.0,
            evaluation_index_path="assets/evaluation_index_re10k.json",
        ),
        encoder=replace(base.encoder, log_planes=False, near=1.0, far=100.0),
        optimizer=replace(base.optimizer, gradient_clip_val=0.05),
    )


def _replica(views: int) -> RootCfg:
    base = _scannet(views)
    return replace(
        base,
        mode="test",
        dataset=replace(
            base.dataset, name="replica",
            evaluation_index_path=f"assets/evaluation_index_replica_{views}views.json",
        ),
    )


EXPERIMENTS: dict[str, Any] = {
    "scannet/2views": lambda: _scannet(2),
    "scannet/3views": lambda: _scannet(3),
    "scannet/fvt": lambda: _scannet(8, fvt=True),
    "re10k/2views": _re10k,
    "replica/2views": lambda: _replica(2),
    "replica/3views": lambda: _replica(3),
}


def _parse_value(text: str, current: Any, annotation: Any = None) -> Any:
    optional = type(None) in typing.get_args(annotation)
    if (optional or current is None) and text.lower() in ("null", "none"):
        return None
    if current is None or isinstance(current, str):
        if text.lower() in ("null", "none"):
            return None
        args = typing.get_args(annotation)
        inner = next((a for a in args if a is not type(None)), None)
        if inner is int:
            return int(float(text))
        if inner is float:
            return float(text)
        if inner is bool:
            return text.lower() in ("1", "true", "yes")
        return text
    if isinstance(current, bool):
        return text.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(float(text))
    if isinstance(current, float):
        return float(text)
    if isinstance(current, tuple):
        items = [x for x in text.strip("[]() ").split(",") if x]
        elem = current[0] if current else ""
        return tuple(_parse_value(x.strip(), elem) for x in items)
    return text


def apply_override(cfg: Any, dotted: str, value: str) -> Any:
    """Return a copy of ``cfg`` with ``a.b.c`` replaced by parsed ``value``."""
    head, _, rest = dotted.partition(".")
    if not is_dataclass(cfg):
        raise KeyError(f"cannot descend into {type(cfg)} at '{dotted}'")
    if head not in {f.name for f in fields(cfg)}:
        raise KeyError(f"unknown config field '{head}' on {type(cfg).__name__}")
    current = getattr(cfg, head)
    if rest:
        new_value = apply_override(current, rest, value)
    else:
        hints = typing.get_type_hints(type(cfg))
        new_value = _parse_value(value, current, hints.get(head))
    return replace(cfg, **{head: new_value})


def load_config(argv: list[str]) -> RootCfg:
    """Compose a RootCfg from ``+experiment=...`` + dotted overrides."""
    cfg = RootCfg()
    overrides: list[tuple[str, str]] = []
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"arguments must be key=value, got '{arg}'")
        key, value = arg.split("=", 1)
        if key in ("+experiment", "experiment"):
            cfg = EXPERIMENTS[value]()
        else:
            overrides.append((key, value))
    for key, value in overrides:
        cfg = apply_override(cfg, key, value)
    return cfg
