"""Hygiene of the PyTorch port: no JAX (nor matplotlib) inside it,
GPU-default entry points that refuse to fall back to the CPU, and a strict
weight bridge."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.evaluation.harness import run_test
from freesplat_tpu_torch.models.decoder import DecoderCfg, make_decoder
from freesplat_tpu_torch.models.encoder import EncoderFreeSplatCfg, make_encoder
from freesplat_tpu_torch.models.layers import BasicBlock
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import freesplat_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "freesplat_tpu",
                                    "matplotlib", "timm", "lpips"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 20  # every module of the package was imported
    assert bad == "[]", bad


def test_entry_points_default_to_cuda_and_refuse_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_encoder(EncoderFreeSplatCfg(num_depth_candidates=8))
    with pytest.raises(RuntimeError, match="cuda"):
        make_decoder(DecoderCfg())
    cfg = load_config(["+experiment=scannet/2views", "test.save_depth=false"])
    with pytest.raises(RuntimeError, match="cuda"):
        run_test(cfg, batches=iter([]))


def test_training_entry_points_default_to_cuda(monkeypatch):
    from freesplat_tpu_torch.training.lpips import make_lpips
    from freesplat_tpu_torch.training.trainer import TrainCfg, init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(TrainCfg(encoder=EncoderFreeSplatCfg(num_depth_candidates=8)), seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        make_lpips(seed=0)


def test_cli_probe_and_data_entry_points_default_to_cuda(monkeypatch):
    from freesplat_tpu_torch.data.synthetic import SyntheticCfg, synthetic_batches
    from freesplat_tpu_torch.main import main
    from freesplat_tpu_torch.scripts import probe_r3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["dataset.name=synthetic"])
    with pytest.raises(RuntimeError, match="cuda"):
        probe_r3.main(["gather"])
    with pytest.raises(RuntimeError, match="cuda"):
        synthetic_batches(SyntheticCfg())  # before the first batch is drawn
    # A kernel wrapper takes its plain version for CPU tensors only.
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        probe_r3.gather_rows(x, torch.zeros(4, 8, dtype=torch.int32, device="meta"))
    assert torch.equal(probe_r3.gather_rows(torch.ones(4, 8), torch.zeros(4, 8, dtype=torch.int32)),
                       torch.ones(4, 8))


def test_run_test_refuses_unported_options(tmp_path):
    """Every option is ported and runs: the preset's defaults
    (``save_depth``, ``eval_depth``) write the stats files, and so do
    ``encode_view_chunk``, ``save_ply``, ``save_video`` and ``view_shard``
    (in one process it takes the unsharded encode; its 2-rank runs are in
    ``tests/test_torch_view_shard.py``)."""
    base = ["+experiment=scannet/2views", f"test.output_path={tmp_path}"]
    for option in ("test.encode_view_chunk=4", "test.save_ply=true", "test.save_video=true",
                   "test.view_shard=true"):
        assert run_test(load_config([*base, option]), batches=iter([]), device="cpu") == {}
    assert run_test(load_config(base), batches=iter([]), device="cpu") == {}
    assert {p.name for p in tmp_path.iterdir()} == {"benchmark.json", "peak_memory.json",
                                                    "stats.json"}


def _block_variables(seed=0):
    rng = np.random.default_rng(seed)
    conv = lambda i, o, k: {"kernel": rng.standard_normal((k, k, i, o)).astype(np.float32),  # noqa: E731
                            "bias": rng.standard_normal(o).astype(np.float32)}
    return {"params": {"conv1": conv(4, 6, 3), "conv2": conv(6, 6, 3), "downsample": conv(4, 6, 1)}}


def test_bridge_loads_and_is_strict():
    var = _block_variables()
    block = load_flax_variables(BasicBlock(4, 6), var)
    np.testing.assert_array_equal(  # (kh, kw, I, O) -> (O, I, kh, kw)
        block.conv1.weight.detach().numpy(),
        var["params"]["conv1"]["kernel"].transpose(3, 2, 0, 1),
    )
    missing = _block_variables()
    del missing["params"]["conv2"]["bias"]
    with pytest.raises(ValueError, match="conv2.bias"):
        load_flax_variables(BasicBlock(4, 6), missing)
    extra = _block_variables()
    extra["params"]["conv3"] = extra["params"]["conv2"]
    with pytest.raises(ValueError, match="conv3.weight"):
        load_flax_variables(BasicBlock(4, 6), extra)
    shape = _block_variables()
    shape["params"]["conv2"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(BasicBlock(4, 6), shape)
