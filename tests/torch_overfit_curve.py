"""The overfit proof's training curve, JAX vs the PyTorch port, on the CPU,
from one set of weights.

Both packages take the overrides of ``scripts/overfit_proof.py`` (warm-up
200 steps, learning rate 2e-4, clip 1.0) at a small image shape and train
on one cached synthetic scene (the port's rendering of it; JAX's agrees
within 1e-3).  The weights are JAX's own init
(``init_state`` at ``PRNGKey(--seed)``), bridged into the port; JAX runs
its Pallas rasterizer in interpret mode, the port the plain versions of
its kernels.  Each step's loss and PSNR are printed side by side, and
``--out`` keeps them as JSON.

``--save-port-init DIR`` also writes the bridged init as a port
checkpoint at step 0 (encoder weights and BN buffers, a fresh Adam), so
that the port's CLI trains from JAX's init at full size on the card:
``python -m freesplat_tpu_torch.main <the proof's overrides>
checkpointing.load=DIR``.

Usage (a few seconds a step at 64x64):
  python -m tests.torch_overfit_curve --steps 300 --image-shape 64,64 \
      [--seed 0] [--out curve.json] [--save-port-init DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def proof_overrides(h: int, w: int, steps: int, lr: float = 2e-4) -> list[str]:
    """``overfit_proof``'s training overrides (no checkpoint directory)."""
    return [
        "dataset.name=synthetic",
        f"dataset.image_shape=[{h},{w}]",
        "dataset.synthetic_cache_batches=1",
        f"trainer.max_steps={steps + 1}",
        f"optimizer.max_steps={steps + 1}",
        "optimizer.warm_up_steps=200",
        f"optimizer.lr={lr}",
        "optimizer.gradient_clip_val=1.0",
    ]


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--image-shape", default="64,64")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--save-port-init", default=None)
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)

    import freesplat_tpu.main as jmain
    from freesplat_tpu.config.config import load_config as jload
    from freesplat_tpu.training import trainer as jtr

    import freesplat_tpu_torch.main as tmain
    from freesplat_tpu_torch.config.config import load_config as tload
    from freesplat_tpu_torch.training import trainer as ttr
    from freesplat_tpu_torch.training.checkpoint import save_checkpoint
    from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables

    h, w = (int(x) for x in args.image_shape.split(","))
    overrides = proof_overrides(h, w, args.steps) + [f"seed={args.seed}"]
    jcfg, tcfg = jload(overrides), tload(overrides)

    def train_cfg(pkg, cfg):
        return pkg.TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                            optimizer=cfg.optimizer)

    batch = next(tmain.make_batches(tcfg, "train", device="cpu"))
    views = {k: {kk: np.asarray(vv) for kk, vv in batch[k].items()}
             for k in ("context", "target")}
    jbatch = next(jmain.make_batches(jcfg, "train"))
    for k in ("context", "target"):  # the same scene, rendered by each package
        for kk, vv in views[k].items():
            np.testing.assert_allclose(np.asarray(jbatch[k][kk]), vv, atol=1e-3, err_msg=kk)

    example = jax.tree_util.tree_map(lambda x: x[:1], views)
    jstate = jtr.init_state(train_cfg(jtr, jcfg), jax.random.PRNGKey(args.seed), example)
    jstep = jtr.make_train_step(train_cfg(jtr, jcfg))
    tstate = ttr.init_state(train_cfg(ttr, tcfg), seed=args.seed, device="cpu")
    load_flax_variables(tstate["encoder"], {"params": jstate["params"],
                                            "batch_stats": jstate["batch_stats"]})
    if args.save_port_init:
        save_checkpoint(args.save_port_init, 0, tstate)
    tstep = ttr.make_train_step(train_cfg(ttr, tcfg))

    rows = []
    for i in range(args.steps + 1):
        t0 = time.perf_counter()
        jstate, jm = jstep(jstate, views)
        tstate, tm = tstep(tstate, views)
        row = {"step": i, **{f"jax_{k}": float(jm[k]) for k in ("loss", "psnr", "dropped_instances")},
               **{f"port_{k}": float(tm[k]) for k in ("loss", "psnr", "dropped_instances")}}
        rows.append(row)
        print(f"step {i:4d}  psnr jax {row['jax_psnr']:8.4f} port {row['port_psnr']:8.4f}  "
              f"loss jax {row['jax_loss']:.6g} port {row['port_loss']:.6g}  "
              f"dropped {row['jax_dropped_instances']:.0f}/{row['port_dropped_instances']:.0f}  "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f)
    return rows


if __name__ == "__main__":
    main()
