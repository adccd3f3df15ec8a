"""The probe entry point of the PyTorch port vs the JAX package, on the CPU.

``gather_rows_plain`` (the CPU stand-in of ``csrc/gather_rows.cu``) is held
exactly against the Pallas kernel of ``freesplat_tpu/scripts/probe_r3.py``
(``probe_gather.k``, run with ``interpret=True``) at the probe's six
shapes and inputs, and against ``jnp.take_along_axis`` on wrapped and
out-of-range indices.  Then the port's three probes run at small sizes.
A gather moves values without arithmetic, so every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from freesplat_tpu_torch.scripts import probe_r3 as P
from freesplat_tpu_torch.utils.timing import bench, device_bench


def _pallas_gather(x, idx):
    """The JAX probe's kernel body (probe_r3.py:31-34) in interpret mode."""
    rows, lanes = x.shape

    def k(x_ref, idx_ref, o_ref):
        o_ref[...] = jnp.take_along_axis(x_ref[...], idx_ref[...], axis=0)

    return pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((rows, lanes), jnp.float32), interpret=True
    )(x, idx)


@pytest.mark.parametrize("rows,lanes", P.GATHER_SHAPES)
def test_plain_gather_equals_pallas_kernel(rows, lanes):
    x, idx = P.gather_inputs(rows, lanes)
    ref = np.asarray(jax.jit(_pallas_gather)(jnp.asarray(x), jnp.asarray(idx)))
    got = P.gather_rows(torch.from_numpy(x), torch.from_numpy(idx))  # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(x, idx.astype(np.int64), 0))


def test_plain_gather_wraps_and_fills_like_jnp():
    rows, lanes = 24, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((rows, lanes)).astype(np.float32)
    # In range, wrapped negatives, and both sides out of range.
    idx = rng.integers(-2 * rows, 2 * rows, (rows, lanes)).astype(np.int32)
    idx[0, :4] = [-rows, -1, rows, -rows - 1]
    ref = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx), axis=0))
    got = P.gather_rows_plain(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)  # NaN where jnp fills
    assert np.isnan(got[0, 2:4]).all() and not np.isnan(got[0, :2]).any()
    bad = (idx < -rows) | (idx >= rows)
    assert bad.any() and (~bad).any()
    np.testing.assert_array_equal(np.isnan(got), bad)
    # The Pallas interpret run shares the semantics.
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(_pallas_gather)(jnp.asarray(x), jnp.asarray(idx))))


def test_gather_rows_checks_its_arguments():
    x = torch.zeros(4, 8)
    with pytest.raises(RuntimeError, match="unsupported device"):
        P.gather_rows(x.to("meta"), torch.zeros(4, 8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="int32"):
        P._check(x, torch.zeros(4, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="float32"):
        P._check(x.double(), torch.zeros(4, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        P._check(torch.zeros(8, 4).t(), torch.zeros(4, 8, dtype=torch.int32))


def test_bench_counts_calls_on_the_host_clock():
    calls = []
    secs = bench(lambda a: calls.append(a), [(1,), (2,)], n=5, warmup=2)
    assert calls == [1, 2, 1, 2, 1, 2, 1] and secs >= 0.0


def test_device_bench_takes_the_host_clock_on_cpu_tensors():
    calls = []
    args = [(torch.zeros(2),), (torch.ones(2),)]
    secs = device_bench(lambda a: calls.append(float(a[0])), args, n=3, warmup=1)
    assert calls == [0.0, 0.0, 1.0, 0.0] and secs >= 0.0


def test_probes_run_small_on_cpu(capsys):
    res = P.probe_gather(shapes=((8, 128), (64, 96)), device="cpu")
    assert [(r["rows"], r["lanes"]) for r in res] == [(8, 128), (64, 96)]
    assert all(r["max_abs_err"] == 0.0 and r["ms"] > 0 for r in res)
    raster = P.probe_raster(n=600, image_shape=(32, 48), device="cpu")
    # On the CPU both sides of the parity line are the plain versions.
    assert raster["color_max_abs"] == 0.0 and raster["grad_max_abs"] == 0.0
    assert raster["fwd_ms"] > 0 and raster["fwdbwd_ms"] > 0
    sweep = P.probe_sweep(b=1, h=8, w=16, c=8, d=4, device="cpu")
    assert sweep["fwd_ms"] > 0 and sweep["fwdbwd_ms"] > 0
    out = capsys.readouterr().out
    assert "gather (64,96): OK" in out and "raster: fwd" in out and "cost volume" in out
    with pytest.raises(ValueError, match="unknown probe"):
        P.main(["bogus"], device="cpu")
