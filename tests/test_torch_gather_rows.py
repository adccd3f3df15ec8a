"""The row gather's CPU path vs ``jnp.take_along_axis``, on the cases the
card checks.

``csrc/gather_rows.cu`` runs only on the card, where ``chip_smoke.py``
holds it against ``gather_rows_plain`` on wrapped and out-of-range indices
at five shapes, among them lanes % 4 != 0, 16,384 rows and ``x`` at a 4 B
offset into its buffer.  Here the same cases, made from a seed, go through
``gather_rows`` on CPU tensors (its plain version) and through a numpy
walk of the kernel's own index arithmetic (one output element a thread,
row-major), and both must equal jnp's gather, NaN in the same places.
Every comparison is exact: a gather does no arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from freesplat_tpu_torch.scripts import probe_r3 as P


def _inputs(rows, lanes, seed, offset=0):
    """x from a seed as a view ``offset`` floats into its buffer; idx over
    [-2 rows, 2 rows): in range, wrapped and out of range on both sides."""
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal(rows * lanes + offset).astype(np.float32)
    idx = rng.integers(-2 * rows, 2 * rows, (rows, lanes)).astype(np.int32)
    idx.flat[:4] = [-rows, -1, rows, -rows - 1][:idx.size]
    x = torch.from_numpy(buf)[offset:].view(rows, lanes)
    return x, torch.from_numpy(idx)


def _kernel_walk(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The kernel's arithmetic for every thread e at once: lane e % lanes,
    the index wrapped once, then the range test and the flat read."""
    rows, lanes = x.shape
    e = np.arange(rows * lanes, dtype=np.int64)
    r = idx.reshape(-1).astype(np.int64)
    r = np.where(r < 0, r + rows, r)
    ok = (r >= 0) & (r < rows)
    src = np.where(ok, r, 0) * lanes + e % lanes
    return np.where(ok, x.reshape(-1)[src], np.float32(np.nan)).reshape(rows, lanes)


def _jnp_gather(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx), axis=0))


@pytest.mark.parametrize("rows,lanes,offset", [
    (640, 96, 0),
    (12416, 192, 0),
    (12416, 190, 0),  # lanes % 4 != 0
    (16384, 128, 0),
    (12416, 192, 1),  # x at a 4 B offset into its buffer
])
def test_gather_rows_on_cpu_equals_jnp_on_wrapped_indices(rows, lanes, offset):
    x, idx = _inputs(rows, lanes, seed=rows + lanes + offset, offset=offset)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    ref = _jnp_gather(x.numpy(), idx.numpy())
    got = P.gather_rows(x, idx).numpy()
    np.testing.assert_array_equal(got, ref)  # NaN in the same places
    np.testing.assert_array_equal(_kernel_walk(x.numpy(), idx.numpy()), ref)
    bad = (idx.numpy() < -rows) | (idx.numpy() >= rows)
    assert bad.any() and (~bad).any()
    np.testing.assert_array_equal(np.isnan(got), bad)


@settings(max_examples=30, deadline=None)
@given(rows=st.integers(1, 3000), lanes=st.integers(1, 256), offset=st.integers(0, 3),
       seed=st.integers(0, 2**16))
def test_gather_rows_on_cpu_equals_jnp_at_any_shape(rows, lanes, offset, seed):
    x, idx = _inputs(rows, lanes, seed, offset)
    ref = _jnp_gather(x.numpy(), idx.numpy())
    np.testing.assert_array_equal(P.gather_rows(x, idx).numpy(), ref)
    np.testing.assert_array_equal(_kernel_walk(x.numpy(), idx.numpy()), ref)


def test_gather_rows_on_cpu_launches_nothing():
    x, idx = _inputs(64, 8, seed=5, offset=1)
    before = dict(P.launch_count)
    np.testing.assert_array_equal(P.gather_rows(x, idx).numpy(),
                                  P.gather_rows_plain(x, idx).numpy())
    assert dict(P.launch_count) == before
