"""CLI entry point: training and testing.

Port of ``freesplat_tpu/main.py``, with the same override surface:

  python -m freesplat_tpu_torch.main +experiment=scannet/2views
  python -m freesplat_tpu_torch.main +experiment=scannet/2views mode=test \
      checkpointing.load=outputs/checkpoints dataset.roots=[datasets/scannet]

With no dataset on disk, ``dataset.name=synthetic`` trains on the built-in
synthetic Gaussian scenes.  Runs on the GPU unless ``main`` is asked for
the CPU (``device="cpu"``).  Data-parallel training runs one process a
device, each with its own batch of ``data_loader.batch_size``:

  torchrun --nproc_per_node 2 -m freesplat_tpu_torch.main \
      +experiment=scannet/2views trainer.devices=auto

(``parallel/distributed.py``; NCCL on the GPU, gloo with ``device="cpu"``).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .config.config import RootCfg, load_config
from .data.data_module import DataLoaderStageCfg, DataModule
from .data.re10k import DatasetRE10k, DatasetRE10kCfg
from .data.replica import DatasetReplica
from .data.scannet import DatasetScannet, DatasetScannetCfg
from .data.synthetic import SyntheticCfg, synthetic_batches
from .data.view_samplers import (
    ViewSamplerBounded,
    ViewSamplerBoundedCfg,
    ViewSamplerEvaluation,
    ViewSamplerEvaluationCfg,
)
from .parallel.distributed import (
    group_rank,
    make_group,
    maybe_initialize_distributed,
    process_rank,
    rank_device,
    replicate_state,
)
from .training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .training.trainer import TrainCfg, fit, init_state
from .utils.device import resolve_device


def make_view_sampler(cfg: RootCfg, stage: str):
    if stage == "test" or cfg.dataset.view_sampler == "evaluation":
        return ViewSamplerEvaluation(
            ViewSamplerEvaluationCfg(index_path=cfg.dataset.evaluation_index_path)
        )
    return ViewSamplerBounded(
        ViewSamplerBoundedCfg(
            num_context_views=cfg.dataset.num_context_views,
            random=cfg.dataset.fvt_random_contexts,
        ),
        stage=stage,
        is_overfitting=cfg.dataset.overfit_to_scene is not None,
        seed=cfg.data_loader.seed,
    )


def make_data_module(cfg: RootCfg, step_fn=None) -> DataModule:
    """Stage-aware loaders routed by ``dataset.name`` (the reference's
    ``data_module.py`` + DATASETS registry): re10k streams ``.torch``
    chunks (``data/re10k.py``); scannet and replica read the
    directory-per-scene layout, Replica with its test-suffix strip and
    depth intrinsics (``data/replica.py``)."""
    cls = DatasetReplica if cfg.dataset.name == "replica" else DatasetScannet

    def factory(stage: str):
        if cfg.dataset.name == "re10k":
            return DatasetRE10k(
                DatasetRE10kCfg(
                    roots=tuple(cfg.dataset.roots),
                    image_shape=cfg.dataset.image_shape,
                    near=cfg.dataset.near,
                    far=cfg.dataset.far,
                ),
                stage,
                make_view_sampler(cfg, stage),
                seed=cfg.data_loader.seed,
            )
        return cls(
            DatasetScannetCfg(
                roots=tuple(cfg.dataset.roots),
                image_shape=cfg.dataset.image_shape,
                near=cfg.dataset.near,
                far=cfg.dataset.far,
                load_depth=cfg.dataset.load_depth,
                overfit_to_scene=cfg.dataset.overfit_to_scene,
            ),
            stage,
            make_view_sampler(cfg, stage),
        )

    return DataModule(
        factory,
        DataLoaderStageCfg(batch_size=cfg.data_loader.batch_size, seed=cfg.data_loader.seed),
        step_fn=step_fn,
    )


def make_batches(cfg: RootCfg, stage: str, step_fn=None, device: str | torch.device = "cuda",
                 replicated: bool = False):
    """Batches of ``stage``: synthetic ones as tensors on ``device``, scene
    loaders' as numpy arrays (the train step moves them).  Each process of
    a multi-process launch streams its own share, or with ``replicated``
    (the test stage under ``test.view_shard``) every process the same."""
    if cfg.dataset.name == "synthetic":
        # Each process streams distinct scenes: the seed is offset by rank.
        return synthetic_batches(
            SyntheticCfg(
                image_shape=cfg.dataset.image_shape,
                num_context=cfg.dataset.num_context_views,
                num_target=cfg.dataset.synthetic_num_targets,
                seed=cfg.data_loader.seed + (0 if replicated else process_rank()[0]),
                cache_batches=cfg.dataset.synthetic_cache_batches,
                vary_scene=cfg.dataset.synthetic_vary_scene,
                renderer=cfg.dataset.synthetic_renderer,
            ),
            device=device,
        )
    dm = make_data_module(cfg, step_fn=step_fn)
    if stage == "train":
        return dm.train_batches()
    if stage == "val":
        return dm.val_batches()
    return dm.test_batches(replicated=replicated)


def train(cfg: RootCfg, device: str | torch.device = "cuda") -> None:
    """Train with ``trainer.devices`` data-parallel ranks: under a launcher
    (torchrun, or JAX's coordinator variables) one process a device, each
    on ``cuda:LOCAL_RANK`` with its own batch and seed offset by its rank;
    rank 0 logs, writes checkpoints and validates while the others wait at
    a barrier, and every rank reads a checkpoint it resumes from."""
    device = resolve_device(device)
    if maybe_initialize_distributed(device):
        device = rank_device(device)
        print(f"torch.distributed: process {process_rank()[0]}/{process_rank()[1]} on "
              f"{device}", flush=True)
    group = make_group(cfg.trainer.devices)
    rank = group_rank(group)[0]
    train_cfg = TrainCfg(
        encoder=cfg.encoder,
        decoder=cfg.decoder,
        loss=cfg.loss,
        optimizer=cfg.optimizer,
        log_every=cfg.trainer.log_every,
    )
    current_step = {"value": 0}
    batches = make_batches(cfg, "train", step_fn=lambda: current_step["value"], device=device)
    first = next(batches)
    state = init_state(train_cfg, seed=cfg.seed, device=device)

    ckpt_dir = cfg.checkpointing.output_dir
    if cfg.checkpointing.load is not None:
        step = latest_step(cfg.checkpointing.load)
        if step is not None:
            state = restore_checkpoint(
                cfg.checkpointing.load, step, state, strict=cfg.checkpointing.strict
            )
            print(f"restored checkpoint step {step}")
    replicate_state(state, group)

    logger = None
    try:
        from .utils.logger import LocalLogger

        logger = LocalLogger() if rank == 0 else None
    except Exception:
        pass

    def log_fn(step, metrics):
        parts = " ".join(f"{k}={v:.5g}" for k, v in metrics.items())
        print(f"train step {step}: {parts}", flush=True)
        if logger is not None:
            logger.log_scalars(step, metrics)

    val_batches = {"it": None}

    def barrier():
        if group is not None:
            torch.distributed.barrier(group=group)

    def val_fn(step, state):
        from .training.validation import validation_step

        if rank != 0:
            return barrier()
        if val_batches["it"] is None:
            val_batches["it"] = make_batches(cfg, "val", device=device)
        batch = next(val_batches["it"])
        metrics = validation_step(
            cfg.encoder, cfg.decoder, state["encoder"], batch, step,
            save_video=cfg.trainer.val_save_video,
            save_projections=cfg.trainer.val_save_projections,
        )
        print(f"val step {step}: psnr={metrics['psnr']:.2f}", flush=True)
        barrier()

    def checkpoint_fn(step, state):
        if rank == 0:
            save_checkpoint(ckpt_dir, step, state)
        barrier()

    def batch_stream():
        # The bounded sampler reads the step when a batch is drawn and
        # ``fit`` takes one batch per step, so the step is set before each
        # draw.  ``first`` was drawn at step 0; a resumed run discards it
        # and draws anew so the sampler sees the restored step (reference
        # StepTracker, src/misc/step_tracker.py + view_sampler_bounded.py).
        step = int(state["step"])
        current_step["value"] = step
        yield first if step == 0 else next(batches)
        while True:
            step += 1
            current_step["value"] = step
            batch = next(batches, None)
            if batch is None:
                return
            yield batch

    fit(
        train_cfg,
        state,
        batch_stream(),
        cfg.trainer.max_steps,
        lpips=_load_lpips(cfg, device),
        log_fn=log_fn if rank == 0 else None,
        checkpoint_fn=checkpoint_fn,
        checkpoint_every=cfg.checkpointing.every_n_train_steps,
        val_fn=val_fn,
        val_every=cfg.trainer.val_check_interval,
        group=group,
    )


def _load_lpips(cfg: RootCfg, device: str | torch.device = "cuda"):
    """An LPIPS module from ``loss.lpips.weights_path`` (a keypath .npz in
    the flax layout, or an ``lpips``-package .pth), or None: no pretrained
    VGG weights ship, and without them the loss is MSE only, with a note."""
    lp = cfg.loss.lpips
    if lp is None or lp.weight == 0:
        return None
    if lp.weights_path is None:
        print(
            "note: loss.lpips.weights_path not set — LPIPS term disabled "
            "(no pretrained VGG weights bundled)", flush=True,
        )
        return None
    from .training.lpips import load_lpips_params, make_lpips

    return make_lpips(load_lpips_params(lp.weights_path), device=device)


def test(cfg: RootCfg, device: str | torch.device = "cuda") -> None:
    from .evaluation.harness import run_test

    run_test(cfg, lpips=_load_lpips(cfg, device), device=device)


def main(argv: list[str] | None = None, device: str | torch.device = "cuda") -> None:
    device = resolve_device(device)
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    np.random.seed(cfg.seed)
    if cfg.mode == "train":
        train(cfg, device)
    elif cfg.mode == "test":
        test(cfg, device)
    else:
        raise ValueError(f"unknown mode {cfg.mode}")


if __name__ == "__main__":
    main()
