"""The port's seeded init against the JAX package's, on the CPU.

``utils/jax_random.py`` draws flax's default initializers at
``jax.random.PRNGKey(seed)``: the keys and random bits bit-equal to
jax's, the truncated normals bit-equal but for ~1 % of them, which
differ in their last bits (XLA's float32 ``log1p`` is its own), and ``init_like_flax`` gives the JAX package's
encoder and LPIPS weights for the same seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesplat_tpu.training import lpips as jlp
from freesplat_tpu.training import trainer as jtr
from freesplat_tpu_torch.training import trainer as ttr
from freesplat_tpu_torch.training.lpips import make_lpips
from freesplat_tpu_torch.utils import jax_random as R
from freesplat_tpu_torch.utils.flax_bridge import torch_to_jax_variables

# Share of the draws that differ from XLA's on the CPU at all: measured
# 0.87-0.96 %.  Where they differ, by at most 3 float32 ulps in the unit
# draw (near 0, where erfinv is small) and 4 after the scaling: measured
# over 6 seeds x 300,007 draws.
MAX_ULP_SHARE = 0.02
MAX_ULPS = 3


def _key(k) -> tuple[int, int]:
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 111123, 2**31 - 1])
def test_keys_and_bits_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert _key(key) == R.prng_key(seed)
    for data in (0, 1, 0xDEADBEEF):
        assert _key(jax.random.fold_in(key, np.uint32(data))) == R.fold_in(
            R.prng_key(seed), data)
    want = np.asarray(jax.random.bits(key, (5000,), jnp.uint32))
    assert np.array_equal(R.random_bits(R.prng_key(seed), np.arange(5000, dtype=np.uint32)),
                          want)


@pytest.mark.parametrize("seed,shape", [(0, (3, 3, 16, 24)), (7, (70001,))])
def test_truncated_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(seed), -2, 2, shape,
                                                  jnp.float32))
    got = R.truncated_normal(R.prng_key(seed), shape)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=MAX_ULPS)
    assert (got != want).mean() <= MAX_ULP_SHARE
    assert got.min() > -2 and got.max() < 2


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _hold(got_tree, want_tree):
    got, want = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_max_ulp(got[k], want[k], maxulp=MAX_ULPS + 1)
    n = sum(v.size for v in want.values())
    assert sum((got[k] != want[k]).sum() for k in want) / n <= MAX_ULP_SHARE


def test_encoder_init_is_jax_init():
    """The whole encoder at the CLI's default seed: every parameter of
    the JAX package's ``init_state`` (817 leaves, 50 M weights)."""
    seed = 111123
    example = {"context": {"image": np.zeros((1, 2, 64, 64, 3), np.float32),
                           "near": np.ones((1, 2), np.float32),
                           "far": np.full((1, 2), 100.0, np.float32)}}
    want = jtr.init_state(jtr.TrainCfg(), jax.random.PRNGKey(seed), example)
    torch.manual_seed(0)  # the draws do not read torch's generator
    got = ttr.init_state(ttr.TrainCfg(), seed=seed, device="cpu")["encoder"]
    variables = torch_to_jax_variables(got)
    _hold(variables["params"], jax.tree_util.tree_map(np.asarray, dict(want["params"])))
    stats = dict(_leaves(variables["batch_stats"]))
    assert all(np.all(v == (1.0 if k.endswith("var") else 0.0)) for k, v in stats.items())


def test_lpips_init_is_jax_init():
    img = jnp.zeros((1, 32, 32, 3))
    want = jlp.LPIPS().init(jax.random.PRNGKey(3), img, img)
    got = torch_to_jax_variables(make_lpips(device="cpu", seed=3))
    _hold(got["params"], jax.tree_util.tree_map(np.asarray, dict(want["params"])))
