"""The rest of the Gaussian math and the splatter smoke, JAX vs the PyTorch
port, on the CPU.

``band_rotation_matrices``, ``rotate_sh`` (degrees 0-3, batched),
``matrix_to_quaternion``, ``covariance_upper_triangle`` and ``matmul3``
at seeded numpy inputs within 1e-5; the rotation property
``eval_sh(rotate_sh(c, R), R @ d) == eval_sh(c, d)``; and
``scripts/test_splatter``'s frames against JAX's at 4 frames within 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from freesplat_tpu.ops import gaussians as jg
from freesplat_tpu.ops import sh as jsh
from freesplat_tpu_torch.ops import gaussians as tg
from freesplat_tpu_torch.ops import sh as tsh

TOL = 1e-5


def rotations(rng, *batch):
    n = int(np.prod(batch)) if batch else 1
    r = Rotation.random(n, random_state=rng).as_matrix().astype(np.float32)
    return r.reshape(*batch, 3, 3)


def test_band_pseudo_inverses_equal_jax():
    for l in range(4):
        np.testing.assert_array_equal(tsh._BAND_PINV[l], jsh._BAND_PINV[l])
    np.testing.assert_array_equal(tsh._DIRS, jsh._DIRS)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_band_rotation_matrices_match_jax(degree):
    rng = np.random.default_rng(10 + degree)
    rot = rotations(rng, 2, 3)
    ours = tsh.band_rotation_matrices(torch.from_numpy(rot), degree)
    ref = jsh.band_rotation_matrices(jnp.asarray(rot), degree)
    assert len(ours) == len(ref) == degree + 1
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_rotate_sh_matches_jax_batched(degree):
    rng = np.random.default_rng(20 + degree)
    n = tsh.num_sh_coeffs(degree)
    c = rng.normal(size=(4, 5, 3, n)).astype(np.float32)
    rot = rotations(rng, 4, 5)[:, :, None]  # one rotation a Gaussian, shared by its channels
    ours = tsh.rotate_sh(torch.from_numpy(c), torch.from_numpy(rot)).numpy()
    ref = np.asarray(jsh.rotate_sh(jnp.asarray(c), jnp.asarray(rot)))
    assert ours.shape == c.shape
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_rotate_sh_follows_the_rotation(degree):
    """eval_sh(rotate_sh(c, R), R @ d) == eval_sh(c, d)."""
    rng = np.random.default_rng(30 + degree)
    n = tsh.num_sh_coeffs(degree)
    c = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    rot = torch.from_numpy(rotations(rng))
    d = rng.normal(size=(50, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    rotated = tsh.rotate_sh(c, rot)
    lhs = tsh.eval_sh(rotated[None].expand(50, 3, n), d @ rot.T, degree)
    rhs = tsh.eval_sh(c[None].expand(50, 3, n), d, degree)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-4, rtol=0)


def test_rotate_sh_identity():
    c = torch.from_numpy(np.random.default_rng(5).normal(size=(7, 3, 16)).astype(np.float32))
    out = tsh.rotate_sh(c, torch.eye(3).expand(7, 3, 3, 3))
    np.testing.assert_allclose(out.numpy(), c.numpy(), atol=TOL, rtol=0)


def test_matrix_to_quaternion_matches_jax():
    rng = np.random.default_rng(40)
    mats = rotations(rng, 64)
    # Pivot cases: identity (trace), and 180-degree turns about x, y, z.
    special = np.stack([np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]),
                        np.diag([-1, -1, 1])]).astype(np.float32)
    mats = np.concatenate([mats, special]).reshape(4, 17, 3, 3)
    ours = tg.matrix_to_quaternion(torch.from_numpy(mats)).numpy()
    ref = np.asarray(jg.matrix_to_quaternion(jnp.asarray(mats)))
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    back = tg.quaternion_to_matrix(torch.from_numpy(ours)).numpy()
    np.testing.assert_allclose(back, mats, atol=1e-5, rtol=0)


def test_covariance_upper_triangle_and_matmul3_match_jax():
    rng = np.random.default_rng(50)
    a = rng.normal(size=(3, 8, 3, 3)).astype(np.float32)
    b = rng.normal(size=(3, 8, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.matmul3(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jg.matmul3(jnp.asarray(a), jnp.asarray(b))),
                               atol=TOL, rtol=0)
    cov = a @ np.swapaxes(a, -1, -2)
    ours = tg.covariance_upper_triangle(torch.from_numpy(cov)).numpy()
    ref = np.asarray(jg.covariance_upper_triangle(jnp.asarray(cov)))
    np.testing.assert_array_equal(ours, ref)


def test_splatter_frames_match_jax(tmp_path, monkeypatch):
    from freesplat_tpu.scripts import test_splatter as jax_splatter
    from freesplat_tpu_torch.scripts import test_splatter

    captured = {}
    monkeypatch.setattr(jax_splatter, "save_video",
                        lambda frames, path, fps: captured.setdefault("frames", frames))
    frames = test_splatter.main(str(tmp_path / "port"), num_frames=4, device="cpu")
    jax_splatter.main(str(tmp_path / "jax"), num_frames=4)
    assert len(frames) == len(captured["frames"]) == 4
    for i, (ours, ref) in enumerate(zip(frames, captured["frames"])):
        assert ours.shape == (128, 128, 3)
        assert ours.max() > 0.1  # the Gaussian is in view
        np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5, rtol=0)
        assert (tmp_path / "port" / f"{i:03}.png").exists()
    assert (tmp_path / "port" / "spin.gif").stat().st_size > 0
