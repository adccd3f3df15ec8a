"""``test.view_shard`` of the port's harness on the CPU, in gloo groups of
2 ranks (``tests/test_torch_parallel.py::run_ranks``): a scene's context
views split over the ranks for the encode, held against the unsharded
port (itself held against JAX's ``run_test`` by
``tests/test_torch_eval.py``).  JAX's own ``view_shard`` raises under its
default options (``tests/test_torch_ddp.py::
test_jax_view_shard_raises_under_batch_statistics``)."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.evaluation.harness import run_test
from freesplat_tpu_torch.models import encoder as tenc
from tests.test_torch_ddp import _one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_ddp import make_batch
from tests.test_torch_parallel import run_ranks


def _scene(v, seed, h=32, w=64):
    """A served scene of ``v`` context views and one target view."""
    return {"scene": [f"scene_{v}"], **make_batch(1, v=v, h=h, w=w, seed=seed)}


def _view_shard_worker(rank, world, tmp, overrides):
    from freesplat_tpu_torch.evaluation import harness

    calls = []
    make = harness.make_chunked_encode

    def counted(*a, **kw):
        encode = make(*a, **kw)

        def run(context):
            calls.append(kw.get("group") is not None)
            return encode(context)
        return run

    harness.make_chunked_encode = counted
    cfg = load_config(["+experiment=scannet/2views", f"test.output_path={tmp}/out_{rank}",
                       "test.view_shard=true", *overrides])
    scenes = [_scene(4, 1), _scene(3, 2)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        summary = run_test(cfg, batches=iter(scenes), device="cpu")
    return summary, calls, out.getvalue()


def _unsharded(overrides, v):
    cfg = load_config(["+experiment=scannet/2views", "test.save_depth=false", *overrides])
    encoder = tenc.make_encoder(dataclasses.replace(cfg.encoder, train_bn=cfg.test.bn_batch_stats),
                                device="cpu", seed=cfg.seed)
    ctx = {k: torch.from_numpy(x) for k, x in _scene(v, 1)["context"].items()}
    with torch.no_grad():
        return encoder(ctx)


@pytest.mark.parametrize("bn_batch_stats", [True, False])
def test_run_test_view_shard_on_two_ranks(tmp_path, capsys, bn_batch_stats):
    """``run_test`` with ``test.view_shard=true`` at 2 ranks: a 4-view
    scene's encode is split over them, and its PSNR equals the unsharded
    port's within 1e-4 relative and its Gaussian count within 0.1 % of
    the slots under both BN regimes (with batch statistics the ranks' BNs
    share them: the monolithic encode's);
    a 3-view scene takes the unsharded encode with JAX's note; only rank 0
    writes files."""
    overrides = ["encoder.num_depth_candidates=8", "encoder.adapter.sh_degree=1",
                 "decoder.sh_degree=1", "test.save_depth=false",
                 f"test.bn_batch_stats={str(bn_batch_stats).lower()}"]
    outs = run_ranks(_view_shard_worker, 2, str(tmp_path), overrides)
    (s0, calls0, text0), (s1, calls1, text1) = outs
    assert calls0 == calls1 == [True]  # the 4-view scene sharded; the 3-view one not
    note = "[test] view_shard: 3 views not divisible by 2 devices — unsharded encode"
    assert note in text0 and note in text1 and "4 views not divisible" not in text0
    assert s0 == s1
    assert (tmp_path / "out_0" / "stats.json").exists()
    assert not (tmp_path / "out_1").exists()
    per_scene = json.loads((tmp_path / "out_0" / "stats.json").read_text())["per_scene"]

    # The unsharded port on the same scenes and weights.
    cfg = load_config(["+experiment=scannet/2views", f"test.output_path={tmp_path / 'one'}",
                       *overrides])
    ref = run_test(cfg, batches=iter([_scene(4, 1), _scene(3, 2)]), device="cpu")
    ref_scene = json.loads((tmp_path / "one" / "stats.json").read_text())["per_scene"]
    for got, want in zip(per_scene, ref_scene):
        # PTF's discrete matches on depths a rounding apart: 7024 against
        # 7025 Gaussians with batch statistics (of 8192 slots).
        assert abs(got["num_gaussians"] - want["num_gaussians"]) <= 1e-3 * 4 * 32 * 64
        np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-4)
    assert set(s0) == set(ref)


def test_view_sharded_encode_equals_monolithic():
    """The view-sharded encode (2 ranks, 2 views each) against the port's
    monolithic encode of the 4 views with batch-statistics BN: depths
    within 1e-4; PTF's discrete matches on depths a rounding apart move a
    few slots (3 of 21,072 coordinates off by up to 0.036 in one run), so
    the valid masks may differ on 0.5 % of the slots and the means of the
    slots valid in both agree within 1e-3 on 99.5 % of them."""
    overrides = ["encoder.num_depth_candidates=8", "encoder.adapter.sh_degree=1",
                 "test.bn_batch_stats=true"]
    ref = _unsharded(overrides, 4)
    outs = run_ranks(_encode_worker, 2, overrides)
    for out in outs:
        np.testing.assert_allclose(out["depth"], ref["depth_s-1"].numpy(), atol=1e-4)
        valid = out["mask"] & ref["gaussians"].mask[0].numpy()
        assert (out["mask"] != ref["gaussians"].mask[0].numpy()).mean() <= 5e-3
        err = np.abs(out["means"][valid] - ref["gaussians"].means[0].numpy()[valid]).max(-1)
        assert (err <= 1e-3).mean() >= 0.995


def _encode_worker(rank, world, overrides):
    from freesplat_tpu_torch.evaluation.harness import make_chunked_encode

    cfg = load_config(["+experiment=scannet/2views", *overrides])
    encoder = tenc.make_encoder(dataclasses.replace(cfg.encoder, train_bn=cfg.test.bn_batch_stats),
                                device="cpu", seed=cfg.seed)
    ctx = {k: torch.from_numpy(x) for k, x in _scene(4, 1)["context"].items()}
    with torch.no_grad():
        res = make_chunked_encode(encoder, None, group=dist.group.WORLD)(ctx)
    return {"depth": res["depth_s-1"].numpy(), "mask": res["gaussians"].mask[0].numpy(),
            "means": res["gaussians"].means[0].numpy()}


def _stream_worker(rank, world, tmp, overrides):
    cfg = load_config([*overrides, f"test.output_path={tmp}/out_{rank}"])
    with contextlib.redirect_stdout(io.StringIO()):
        return run_test(cfg, device="cpu")


def test_view_shard_reads_one_stream_on_every_rank(tmp_path):
    """With ``test.view_shard`` every rank reads the whole test stream (the
    same scenes; a training launch gives each rank its own share): on the
    synthetic dataset both ranks' summaries equal the one-process run's
    (PSNR within 1e-4 relative, the Gaussian count within 0.1 % of the
    slots, as above)."""
    overrides = ["+experiment=scannet/2views", "dataset.name=synthetic",
                 "dataset.image_shape=[32,64]", "encoder.num_depth_candidates=8",
                 "encoder.adapter.sh_degree=1", "decoder.sh_degree=1", "test.max_scenes=1",
                 "test.save_depth=false", "test.eval_depth=false", "test.view_shard=true"]
    outs = run_ranks(_stream_worker, 2, str(tmp_path), overrides)
    with contextlib.redirect_stdout(io.StringIO()):
        ref = run_test(load_config([*overrides, f"test.output_path={tmp_path}/one"]),
                       device="cpu")
    assert outs[0] == outs[1]
    np.testing.assert_allclose(outs[0]["psnr"], ref["psnr"], rtol=1e-4)
    assert abs(outs[0]["num_gaussians"] - ref["num_gaussians"]) <= 1e-3 * 2 * 32 * 64
