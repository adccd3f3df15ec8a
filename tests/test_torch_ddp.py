"""Data-parallel training, the CLI's ``trainer.devices`` and the harness's
``test.view_shard`` of the port, on the CPU in gloo groups of 2 ranks
(``tests/test_torch_parallel.py::run_ranks``).

The 2-rank train step (local batch 1 each) is held against JAX's train
step on the global batch of 2 on one device: JAX's own slow test
(``tests/test_distributed_fit.py::test_mesh_step_matches_single_device``)
holds its mesh step equal to that, with the tolerances used here.  This
module imports no JAX at its top: the ranks import it to find their
worker functions.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from freesplat_tpu_torch import main as tmain
from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models.adapter import GaussianAdapterCfg as TAdapterCfg
from freesplat_tpu_torch.models.decoder import DecoderCfg as TDecoderCfg
from freesplat_tpu_torch.parallel.distributed import local_batch, make_group
from freesplat_tpu_torch.training import trainer as ttr
from freesplat_tpu_torch.training.schedule import OptimizerCfg as TOptimizerCfg
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables, torch_to_jax_variables
from tests.test_torch_parallel import run_ranks

OPT = dict(lr=1e-3, warm_up_steps=2, max_steps=50, gradient_clip_val=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(b, v=2, h=32, w=32, seed=0):
    """``tests/test_distributed_fit.py::make_batch``: b scenes of v
    context views and one target view (numpy)."""
    rng = np.random.default_rng(seed)
    intr = np.zeros((b, v, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = 1.1
    intr[..., 0, 2] = intr[..., 1, 2] = 0.5
    intr[..., 2, 2] = 1.0
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    for vi in range(v):
        extr[:, vi, 0, 3] = 0.15 * vi
    ctx = {
        "image": rng.uniform(size=(b, v, h, w, 3)).astype(np.float32),
        "intrinsics": intr, "extrinsics": extr,
        "near": np.full((b, v), 0.5, np.float32), "far": np.full((b, v), 15.0, np.float32),
    }
    tgt = {
        "image": rng.uniform(size=(b, 1, h, w, 3)).astype(np.float32),
        "extrinsics": extr[:, :1], "intrinsics": intr[:, :1],
        "near": ctx["near"][:, :1], "far": ctx["far"][:, :1],
    }
    return {"context": ctx, "target": tgt}


def _tcfg(train_bn):
    return ttr.TrainCfg(
        encoder=tenc.EncoderFreeSplatCfg(num_depth_candidates=8, adapter=TAdapterCfg(sh_degree=1),
                                         train_bn=train_bn),
        decoder=TDecoderCfg(sh_degree=1), optimizer=TOptimizerCfg(**OPT), log_every=1)


def _step_worker(rank, world, train_bn, variables, batch):
    state = ttr.init_state(_tcfg(train_bn), seed=0, device="cpu")
    load_flax_variables(state["encoder"], variables)
    group = make_group(world)
    step = ttr.make_train_step(_tcfg(train_bn), group=group)
    state, metrics = step(state, local_batch(batch, rank, world))
    out = torch_to_jax_variables(state["encoder"])
    return {k: float(v) for k, v in metrics.items()}, out


def test_two_rank_step_matches_jax_global_batch():
    """``check_two_rank_step`` with running-average BN (the train preset's
    ``encoder.train_bn=false``); batch statistics in
    ``tests/test_torch_ddp_bn.py``."""
    check_two_rank_step(train_bn=False)


def check_two_rank_step(train_bn):
    """Two ranks, one scene each, against JAX's step on both scenes: the
    loss within rtol 1e-3 and every parameter within 5e-4 (JAX's mesh-test
    tolerances: the f32 reduction order of the sums differs); the ranks'
    parameters and BN buffers bit-equal to each other; under batch
    statistics the running buffers (from the global batch's statistics)
    within 1e-3 of JAX's, relative L2 over all of them."""
    import jax
    import jax.numpy as jnp
    from freesplat_tpu.models import encoder as jenc
    from freesplat_tpu.models.adapter import GaussianAdapterCfg as JAdapterCfg
    from freesplat_tpu.models.decoder import DecoderCfg as JDecoderCfg
    from freesplat_tpu.training import trainer as jtr
    from freesplat_tpu.training.schedule import OptimizerCfg as JOptimizerCfg
    from tests.test_torch_encoder import fill_variables

    jcfg = jtr.TrainCfg(
        encoder=jenc.EncoderFreeSplatCfg(num_depth_candidates=8, adapter=JAdapterCfg(sh_degree=1),
                                         train_bn=train_bn),
        decoder=JDecoderCfg(sh_degree=1), optimizer=JOptimizerCfg(**OPT), log_every=1)
    batch = make_batch(2, seed=3)
    arrays = jax.tree_util.tree_map(jnp.asarray, batch)
    shapes = jax.eval_shape(
        lambda c: jenc.EncoderFreeSplat(jcfg.encoder).init(jax.random.PRNGKey(0), c),
        jax.tree_util.tree_map(lambda x: x[:1], arrays["context"]))
    var = jax.tree_util.tree_map(np.asarray, fill_variables(shapes, seed=1))
    tx = jtr.make_optimizer(jcfg.optimizer)
    jstate = {"params": var["params"], "batch_stats": var["batch_stats"],
              "opt_state": tx.init(var["params"]), "step": jnp.zeros((), jnp.int32)}
    jstate, jm = jtr.make_train_step(jcfg)(jstate, arrays)

    (m0, v0), (m1, v1) = run_ranks(_step_worker, 2, train_bn, var, batch)
    assert m0 == m1  # every rank logs the global metrics
    leaves = lambda t: jax.tree_util.tree_leaves_with_path(t)  # noqa: E731
    for (p, a), (_, b) in zip(leaves(v0), leaves(v1)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))
    np.testing.assert_allclose(m0["loss"], float(jm["loss"]), rtol=1e-3)
    assert m0["dropped_instances"] == float(jm["dropped_instances"]) == 0
    got = dict((jax.tree_util.keystr(p), x) for p, x in leaves(v0["params"]))
    want = dict((jax.tree_util.keystr(p), np.asarray(x)) for p, x in leaves(jstate["params"]))
    assert got.keys() == want.keys()
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
    assert worst < 5e-4, worst
    moved = max(float(np.abs(got[k] - np.asarray(x)).max())
                for k, x in ((jax.tree_util.keystr(p), x) for p, x in leaves(var["params"])))
    assert moved > 1e-5  # the step did move the parameters
    if train_bn:
        a = np.concatenate([np.ravel(x) for _, x in leaves(v0["batch_stats"])])
        b = np.concatenate([np.ravel(np.asarray(x)) for _, x in leaves(jstate["batch_stats"])])
        start = np.concatenate([np.ravel(x) for _, x in leaves(var["batch_stats"])])
        assert not np.array_equal(a, start)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-3


# ---------------------------------------------------------------------------
# The CLI and the harness.

SMALL = [
    "dataset.name=synthetic", "dataset.image_shape=[32,32]", "encoder.num_depth_candidates=8",
    "encoder.adapter.sh_degree=1", "encoder.train_bn=false", "decoder.sh_degree=1",
    "trainer.log_every=1", "optimizer.warm_up_steps=2", "optimizer.max_steps=10",
    "optimizer.gradient_clip_val=1.0",
]


def _main_worker(rank, world, tmp):
    import contextlib
    import io
    import os

    os.chdir(tmp)  # rank 0's logger writes under outputs/local
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tmain.main([*SMALL, "trainer.devices=2", "trainer.max_steps=2",
                    f"checkpointing.output_dir={tmp}/ckpt",
                    "checkpointing.every_n_train_steps=1"], device="cpu")
        tmain.main([*SMALL, "trainer.devices=auto", "trainer.max_steps=3",
                    f"checkpointing.load={tmp}/ckpt", f"checkpointing.output_dir={tmp}/ckpt2",
                    "checkpointing.every_n_train_steps=100"], device="cpu")
    return out.getvalue()


def test_main_trains_on_two_ranks_and_resumes(tmp_path):
    """``main`` with ``trainer.devices=2`` under 2 gloo ranks: 2 steps,
    the step-1 checkpoint written once (by rank 0), the metrics logged by
    rank 0 only; then ``trainer.devices=auto`` resumes both ranks from it
    for the last step.  One process with ``trainer.devices=2`` raises."""
    texts = run_ranks(_main_worker, 2, str(tmp_path))
    assert "train step 0: loss=" in texts[0] and "train step 1: loss=" in texts[0]
    assert "train step" not in texts[1]
    for text in texts:
        assert "restored checkpoint step 1" in text
    assert "train step 2: loss=" in texts[0] and "train step 1:" not in texts[0].split(
        "restored checkpoint step 1")[1]
    assert [p.name for p in (tmp_path / "ckpt").iterdir()] == ["step_1"]
    steps = [json.loads(line)["step"]
             for line in (tmp_path / "outputs/local/metrics.jsonl").read_text().splitlines()]
    assert steps == [0, 1, 2]
    with pytest.raises(ValueError, match="world size is 1"):
        tmain.main([*SMALL, "trainer.devices=2"], device="cpu")


def test_jax_view_shard_raises_under_batch_statistics():
    """JAX's ``test.view_shard`` encode (``freesplat_tpu/evaluation/
    harness.py`` l.328-352) under its default ``test.bn_batch_stats=true``:
    ``make_view_sharded_encode`` applies the encoder without
    ``mutable=["batch_stats"]``, so train-mode BN raises flax's
    ``ModifyScopeVariableError`` on a host of more than one device (here
    2 of the conftest's CPU devices), at trace time.  With
    ``bn_batch_stats=false`` the same call runs.  The port does not copy
    the fault (``test_run_test_view_shard_on_two_ranks``)."""
    import jax
    import jax.numpy as jnp
    from flax.errors import ModifyScopeVariableError
    from freesplat_tpu.config.config import load_config as jload
    from freesplat_tpu.models.encoder import EncoderFreeSplat
    from freesplat_tpu.parallel.distributed import make_mesh, make_view_sharded_encode
    from tests.test_torch_encoder import fill_variables

    assert len(jax.devices()) > 1
    cfg = jload(["+experiment=scannet/2views", "encoder.num_depth_candidates=8",
                 "encoder.adapter.sh_degree=1"])
    assert cfg.test.bn_batch_stats
    ctx = jax.tree_util.tree_map(jnp.asarray, make_batch(1, v=2)["context"])
    for train_bn in (True, False):
        encoder = EncoderFreeSplat(dataclasses.replace(cfg.encoder, train_bn=train_bn))
        shapes = jax.eval_shape(lambda c: encoder.init(jax.random.PRNGKey(0), c), ctx)
        variables = fill_variables(shapes, seed=2)
        encode = make_view_sharded_encode(encoder, make_mesh(2))
        if train_bn:
            with pytest.raises(ModifyScopeVariableError, match="batch_stats"):
                encode(variables, ctx)
        else:
            jax.eval_shape(encode, variables, ctx)  # traces without the fault
