"""Parity of the rasterizer's gradients: the PyTorch port vs the JAX package,
on the CPU.

The same numpy scenes (``tests/test_torch_render.py::CASES`` plus a scene
culled behind the camera) and the same numpy cotangents go through
``jax.grad`` of the JAX ``rasterize`` (its Pallas forward and backward
kernels in interpret mode) and through the port's ``rasterize`` (its
autograd Function, which on CPU tensors runs ``composite_tiles_plain`` and
``composite_tiles_plain_bwd``, the CUDA kernels' plain versions).
Gradients are compared at the repo's gradient tolerance: 2e-4 after
scaling by each leaf's largest magnitude
(``tests/test_rasterizer_pallas.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesplat_tpu.ops import rasterizer as jras
from freesplat_tpu_torch.ops import rasterizer as tras
from freesplat_tpu_torch.ops.rendering import preprocess_gaussians
from tests.test_torch_render import CASES, H, W, make_scene

GRAD_TOL = 2e-4
LEAVES = ("means", "covariances", "harmonics", "opacities")
GRAD_CASES = {**CASES, "culled": (dict(n=20, seed=4), {}, None, (H, W), (0.5, 0.6, 0.7))}


def _case_inputs(case):
    scene_kw, kw, op, shape, bg = GRAD_CASES[case][:5]
    means, cov, harm, opac, extr, intr = make_scene(sh_d=4, **scene_kw)
    if op is not None:
        opac = np.full_like(opac, op)
    if case == "culled":
        means = means - np.array([0.0, 0.0, 30.0], np.float32)  # all behind the camera
    rng = np.random.default_rng(100)
    cot = tuple(rng.standard_normal(s).astype(np.float32) for s in ((*shape, 3), shape, shape))
    return (means, cov, harm, opac), (extr, intr), shape, np.asarray(bg, np.float32), kw, cot


def _jax_grads(leaves, cams, shape, bg, kw, cot):
    def loss(m, c, h, o):
        color, depth, alpha = jras.rasterize(m, c, h, o, jnp.asarray(cams[0]), jnp.asarray(cams[1]),
                                             shape, jnp.asarray(bg), 1, **kw)
        return (jnp.sum(color * cot[0]) + jnp.sum(depth * cot[1])
                + jnp.sum(alpha * cot[2]))

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*[jnp.asarray(a) for a in leaves])
    return [np.asarray(g) for g in grads]


def _torch_grads(leaves, cams, shape, bg, kw, cot):
    xs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in leaves]
    color, depth, alpha = tras.rasterize(*xs, *[torch.from_numpy(c) for c in cams], shape,
                                         torch.from_numpy(bg), 1, **kw)
    loss = ((color * torch.from_numpy(cot[0])).sum() + (depth * torch.from_numpy(cot[1])).sum()
            + (alpha * torch.from_numpy(cot[2])).sum())
    loss.backward()
    return [x.grad.numpy() for x in xs]


def _scaled_err(got, ref):
    scale = np.abs(ref).max()
    if scale == 0.0:
        return np.abs(got).max()
    return np.abs(got - ref).max() / scale


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_rasterize_grads_match_jax(case):
    leaves, cams, shape, bg, kw, cot = _case_inputs(case)
    jg = _jax_grads(leaves, cams, shape, bg, kw, cot)
    tg = _torch_grads(leaves, cams, shape, bg, kw, cot)
    for name, a, b in zip(LEAVES, tg, jg):
        assert np.isfinite(a).all(), f"{case} {name}: non-finite"
        err = _scaled_err(a, b)
        assert err <= GRAD_TOL, f"{case} {name}: scaled error {err:.3g}"
    if case == "culled":  # nothing on screen: every gradient is exactly zero
        assert all(np.abs(g).max() == 0.0 for g in tg)
    else:
        assert np.abs(tg[0]).max() > 0 and np.abs(tg[3]).max() > 0


def _instances(case):
    leaves, cams, shape, _, kw, _ = _case_inputs(case)
    n = leaves[0].shape[0]
    cap = kw.get("capacity", tras.render_capacity(n, 3.0))
    cap = -(-cap // tras.CHUNK) * tras.CHUNK
    with torch.no_grad():
        screen = preprocess_gaussians(*[torch.from_numpy(a) for a in leaves + cams], shape, 1)
        binning = tras.bin_gaussians(screen, shape, cap)
        inst = tras.build_instance_rows(screen, binning)
    return inst, binning, -(-shape[1] // 16)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_plain_backward_matches_autograd(case):
    """composite_tiles_plain_bwd (the CUDA backward's plain version) vs
    torch autograd through composite_tiles_plain (the forward's), on the
    same instance rows and a numpy cotangent.  Float32 sums over a tile's
    pixels in another order: 1e-5 after scaling (measured ~6e-7)."""
    inst, binning, tiles_x = _instances(case)
    args = (binning.tile_start, binning.tile_count, tiles_x)
    leaf = inst.clone().requires_grad_(True)
    out, walk = tras.composite_tiles_plain(leaf, *args)
    cot = torch.from_numpy(
        np.random.default_rng(7).standard_normal(tuple(out.shape)).astype(np.float32))
    if inst.shape[0] == 0:  # the culled scene: no instance, nothing to differentiate
        assert int(walk.max()) == 0
        assert tras.composite_tiles_plain_bwd(inst, *args, out, walk, cot).shape == (0, 10)
        return
    (out * cot).sum().backward()
    ref = leaf.grad
    got = tras.composite_tiles_plain_bwd(inst, *args, out.detach(), walk, cot)
    for col in range(10):
        err = _scaled_err(got[:, col].numpy(), ref[:, col].numpy())
        assert err <= 1e-5, f"{case} column {col}: scaled error {err:.3g}"
    # The autograd Function on CPU tensors is exactly the two plain versions.
    leaf2 = inst.clone().requires_grad_(True)
    out2 = tras.composite_tiles(leaf2, *args)
    (out2 * cot).sum().backward()
    assert torch.equal(out2.detach(), out.detach())
    assert torch.equal(leaf2.grad, got)


def test_walk_residual_and_unreached_rows():
    """The forward's residual is one past each pixel's last blended
    instance; the backward's rows past every pixel's walk (and past the
    16384 per-tile cap) are zero."""
    inst, binning, tiles_x = _instances("dense_overlap")
    args = (binning.tile_start, binning.tile_count, tiles_x)
    out, walk = tras.composite_tiles_plain(inst, *args)
    assert walk.dtype == torch.int32 and walk.shape == out.shape[:2]
    cnt = binning.tile_count.long()
    assert bool((walk.long() <= cnt[:, None]).all())
    # Opaque overlap: pixels terminate before their tile's last instance.
    assert bool((walk.max(1).values.long() < cnt).any())
    cot = torch.ones_like(out)
    dinst = tras.composite_tiles_plain_bwd(inst, *args, out, walk, cot)
    start = binning.tile_start.long()
    for t in range(cnt.shape[0]):
        lo = int(start[t] + walk[t].max())
        hi = int(start[t] + cnt[t])
        assert bool((dinst[lo:hi] == 0).all()), t


def test_composite_tiles_accepts_grad_and_refuses_other_devices():
    inst, binning, tiles_x = _instances("random_s0")
    leaf = inst.clone().requires_grad_(True)
    out = tras.composite_tiles(leaf, binning.tile_start, binning.tile_count, tiles_x)
    assert out.requires_grad and out.shape == (binning.tile_start.shape[0], tras.P, 5)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tras.composite_tiles_fwd(inst.to("meta"), binning.tile_start, binning.tile_count,
                                 tiles_x)
