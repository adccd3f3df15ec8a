"""The port's multi-device pieces against the JAX package, on the CPU.

Ranks are processes in a gloo group (``run_ranks``: spawned with
``torch.multiprocessing``, ``init_method="file://..."``, torch on one
thread, joined with a timeout; a worker's exception fails the test).  The
JAX side runs in this process on the conftest's CPU devices, jitted, its
Pallas kernels in interpret mode.  JAX's own sharded functions compile for
minutes on the CPU, so each case compares with the single-device JAX
function that JAX's slow tests hold them equal to
(``tests/test_sharded_render.py``, ``tests/test_sharded_ptf.py``) unless
its docstring says otherwise.  This module imports no JAX at its top: the
ranks import it to find their worker functions.
"""
from __future__ import annotations

import functools
import os
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from freesplat_tpu_torch.ops import rasterizer as tras
from freesplat_tpu_torch.ops import rendering as trend
from freesplat_tpu_torch.parallel import distributed as tdist
from freesplat_tpu_torch.parallel.sharded_ptf import fuse_views_sharded
from freesplat_tpu_torch.parallel.sharded_render import (
    gather_screen, rasterize_sharded, render_slab, slab_capacity,
)

H, W = 32, 128  # 2 x 8 tiles: 4 columns a rank at 2 ranks, 2 at 4
INTR = np.array([[0.55, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Ranks.


def _rank_entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    try:
        torch.save(fn(rank, world, *args), os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 300.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes of one
    gloo group; returns each rank's result.  A worker's exception is
    raised here (the others are terminated); past ``timeout`` every worker
    is killed and the test fails."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_entry, args=(fn, world, tmp, args), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks of {fn.__name__} did not finish in {timeout} s")
        return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
                for r in range(world)]


def make_scene(n=192, seed=0, spread=2.0):
    """A numpy Gaussian scene, as ``tests/test_torch_render.py::make_scene``
    (covariances from scales and rotations by the port's
    ``build_covariance``: both packages read the same arrays)."""
    from freesplat_tpu_torch.ops.gaussians import build_covariance

    rng = np.random.default_rng(seed)
    means = rng.uniform([-spread, -spread, 1.0], [spread, spread, 8.0], (n, 3)).astype(np.float32)
    scales = rng.uniform(0.03, 0.35, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    cov = build_covariance(torch.from_numpy(scales), torch.from_numpy(q)).numpy()
    harm = (rng.normal(size=(n, 3, 4)) * 0.4).astype(np.float32)
    opac = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return means, cov, harm, opac


def _screen(args, shape=(H, W), sh_degree=1):
    """The port's screen parameters of a scene (numpy fields)."""
    means, cov, harm, opac = (torch.from_numpy(a) for a in args)
    with torch.no_grad():
        s = trend.preprocess_gaussians(means, cov, harm, opac, torch.eye(4),
                                       torch.from_numpy(INTR), shape, sh_degree)
    return {k: getattr(s, k).numpy() for k in s._fields}


def _jax_screen(fields):
    import jax.numpy as jnp
    from freesplat_tpu.ops import rendering as jrend

    return jrend.Screen(**{k: jnp.asarray(v) for k, v in fields.items()})


def _torch_screen(fields, requires_grad=False):
    out = {k: torch.from_numpy(np.array(v)) for k, v in fields.items()}
    if requires_grad:
        for k in _GRAD_FIELDS:
            out[k].requires_grad_()
    return trend.Screen(**out)


# ---------------------------------------------------------------------------
# Slabs: the kernels' plain versions and the binning at a column offset.


_GRAD_FIELDS = ("means2d", "conics", "colors", "opacities", "depths")


@functools.lru_cache(maxsize=None)
def _jax_slab_fn(shape, capacity, local_cols, col_off):
    import jax
    import jax.numpy as jnp
    from freesplat_tpu.ops import rasterizer as jras

    from freesplat_tpu.ops import rendering as jrend

    th = -(-shape[0] // 16)

    def slab(cols, radii, mask, cot):
        screen = jrend.Screen(**cols, radii=radii, mask=mask)
        b = jras.bin_gaussians(screen, shape, capacity, num_local_cols=local_cols,
                               col_offset=col_off)
        inst = jras.build_instance_rows(screen, b)
        tw = jnp.array([local_cols, col_off], jnp.int32)
        out = jras._rasterize_tiles(inst, b.tile_start, b.tile_count, tw, th * local_cols)
        return jnp.sum(out[..., :5] * cot), (out, b)

    step = jax.jit(jax.value_and_grad(slab, has_aux=True))

    def run(fields, cot):
        cols = {k: jnp.asarray(fields[k]) for k in _GRAD_FIELDS}
        return step(cols, jnp.asarray(fields["radii"]), jnp.asarray(fields["mask"]), cot)

    return run


@pytest.mark.parametrize("world,rank", [(2, 1), (4, 2), (4, 3)])
def test_slab_plain_versions_match_jax(world, rank):
    """The compositor's plain versions at a slab (``col_offset = rank *
    local_cols``) against JAX's ``_rasterize_tiles`` with ``tw_arr =
    [local_cols, col_off]`` (its Pallas kernels in interpret mode) on the
    same screen parameters and binning of that slab: the output (color,
    depth, log T) and the gradient of a seeded linear loss of it with
    respect to the screen parameters.  Tolerances as
    ``tests/test_torch_raster_grad.py``: output 3e-5, gradient 3e-4 after
    scaling by each field's largest magnitude."""
    fields = _screen(make_scene(seed=rank))
    local_cols = (W // 16) // world
    col_off = rank * local_cols
    cap = tras.render_capacity(192, 3.0)
    th = H // 16
    rng = np.random.default_rng(7)
    cot = rng.standard_normal((th * local_cols, 256, 5)).astype(np.float32)
    (_, (jout, jbin)), jgrad = _jax_slab_fn((H, W), cap, local_cols, col_off)(fields, cot)

    screen = _torch_screen(fields, requires_grad=True)
    slab, binning, _ = render_slab(screen, rank, world, (H, W), cap)
    out = slab.reshape(th, 16, local_cols, 16, 5).permute(0, 2, 1, 3, 4).reshape(-1, 256, 5)
    assert int(binning.num_instances) == int(jbin.num_instances) > 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout)[..., :5], atol=3e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    for k in _GRAD_FIELDS:
        got, want = getattr(screen, k).grad.numpy(), np.asarray(jgrad[k])
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got / scale, want / scale, atol=3e-4, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_bin_gaussians_slab_matches_jax(world):
    """Every slab's binning equals JAX's: the tile counts, each tile's
    Gaussian ids in depth order, ``num_instances`` and ``dropped`` (also
    under a budget that cuts).  JAX aligns each tile's start to 128 slots,
    so starts are compared through the per-tile id lists; and the slabs
    of all ranks together hold the whole image's binning, tile for
    tile."""
    import jax
    from freesplat_tpu.ops import rasterizer as jras

    fields = _screen(make_scene(seed=3))
    js, ts = _jax_screen(fields), _torch_screen(fields)
    local_cols = (W // 16) // world
    full = tras.bin_gaussians(ts, (H, W), 4096)

    def tiles(b, n):
        ids, start, count = (np.asarray(x) for x in (b.sorted_ids, b.tile_start, b.tile_count))
        return [ids[start[t]:start[t] + count[t]].tolist() for t in range(n)]

    slabs = []
    for cap in (4096, 256):
        for rank in range(world):
            jb = jax.jit(functools.partial(jras.bin_gaussians, image_shape=(H, W), capacity=cap,
                                           num_local_cols=local_cols,
                                           col_offset=rank * local_cols))(js)
            tb = tras.bin_gaussians(ts, (H, W), cap, num_local_cols=local_cols,
                                    col_offset=rank * local_cols)
            n = (H // 16) * local_cols
            np.testing.assert_array_equal(tb.tile_count.numpy(), np.asarray(jb.tile_count))
            assert tiles(tb, n) == tiles(jb, n)
            assert int(tb.num_instances) == int(jb.num_instances)
            assert int(tb.dropped) == int(jb.dropped)
            if cap == 4096:
                slabs.append((rank, tiles(tb, n)))
    whole = tiles(full, (H // 16) * (W // 16))
    for rank, slab in slabs:
        for t, ids in enumerate(slab):
            row, col = divmod(t, local_cols)
            assert ids == whole[row * (W // 16) + rank * local_cols + col]


# ---------------------------------------------------------------------------
# The sharded render.


def _render_worker(rank, world, scene, cot, per_device_capacity):
    means, cov, harm, opac = (torch.from_numpy(a) for a in scene)
    n = means.shape[0] // world
    mine = slice(rank * n, (rank + 1) * n)
    leaves = [t[mine].clone().requires_grad_() for t in (means, cov, harm, opac)]
    color, depth, alpha, stats = rasterize_sharded(
        *leaves, torch.eye(4), torch.from_numpy(INTR), (H, W), torch.tensor([0.1, 0.2, 0.3]), 1,
        group=dist.group.WORLD, capacity=8 * means.shape[0],
        per_device_capacity=per_device_capacity, return_stats=True)
    loss = sum((x * torch.from_numpy(c)).sum() for x, c in zip((color, depth, alpha), cot))
    loss.backward()
    return {"image": [x.detach().numpy() for x in (color, depth, alpha)],
            "grads": [t.grad.numpy() for t in leaves], "dropped": int(stats["dropped"])}


@functools.lru_cache(maxsize=None)
def _jax_render(seed):
    import jax
    import jax.numpy as jnp
    from freesplat_tpu.ops import rasterizer as jras

    scene = make_scene(seed=seed)
    rng = np.random.default_rng(seed + 50)
    cot = tuple(rng.standard_normal(s).astype(np.float32) for s in ((H, W, 3), (H, W), (H, W)))
    bg = jnp.asarray([0.1, 0.2, 0.3])

    def loss(m, c, h, o):
        out = jras.rasterize(m, c, h, o, jnp.eye(4), jnp.asarray(INTR), (H, W), bg, 1,
                             capacity=8 * 192)
        return sum(jnp.sum(x * k) for x, k in zip(out, cot)), out

    (_, image), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *[jnp.asarray(a) for a in scene])
    return scene, cot, [np.asarray(x) for x in image], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", [2, 4])
def test_rasterize_sharded_matches_jax(world):
    """``rasterize_sharded`` at 2 and 4 ranks against JAX's single-device
    ``rasterize`` on the whole scene: every rank's image within JAX's own
    sharded tolerances (color 3e-5, depth 3e-4, alpha 3e-5), each rank's
    gradients of its own shard within 3e-4 after scaling by each leaf's
    largest magnitude, and nothing dropped at the default slab budget."""
    scene, cot, image, grads = _jax_render(world)
    outs = run_ranks(_render_worker, world, scene, cot, None)
    n = 192 // world
    for rank, out in enumerate(outs):
        assert out["dropped"] == 0
        for name, got, want, tol in zip(("color", "depth", "alpha"), out["image"], image,
                                        (3e-5, 3e-4, 3e-5)):
            np.testing.assert_allclose(got, want, atol=tol, err_msg=f"rank {rank} {name}")
        for name, got, want in zip(("means", "cov", "harm", "opac"), out["grads"], grads):
            want = want[rank * n:(rank + 1) * n]
            scale = np.abs(want).max() + 1e-12
            np.testing.assert_allclose(got / scale, want / scale, atol=3e-4,
                                       err_msg=f"rank {rank} d{name}")


def test_rasterize_sharded_reports_overflow():
    """A slab budget of 128 cuts instances: every rank reports the sum of
    the slabs' ``dropped``, which equals the slabs' own counts binned in
    one process (``render_slab`` at each rank of the split)."""
    scene = make_scene(seed=5)
    rng = np.random.default_rng(1)
    cot = tuple(rng.standard_normal(s).astype(np.float32) for s in ((H, W, 3), (H, W), (H, W)))
    outs = run_ranks(_render_worker, 2, scene, cot, 128)
    screen = _torch_screen(_screen(scene))
    want = sum(int(render_slab(screen, r, 2, (H, W), 128)[1].dropped) for r in range(2))
    assert want > 0
    assert [o["dropped"] for o in outs] == [want, want]
    assert slab_capacity(8 * 192, 2) == 1536 and slab_capacity(8 * 192, 8) == 768


def _collectives_worker(rank, world):
    x = torch.arange(6.0).reshape(3, 2) + 10 * rank
    x.requires_grad_()
    g = tdist.all_gather_cat(x, dist.group.WORLD)
    (g * (torch.arange(g.numel()).reshape(g.shape) + 1.0)).sum().backward()
    y = x.detach().clone().requires_grad_()
    r = tdist.gather_replicated(y, dist.group.WORLD, dim=1)
    (r * (torch.arange(r.numel()).reshape(r.shape) + 1.0)).sum().backward()
    z = torch.full((2,), float(rank + 1), requires_grad=True)
    s = tdist.all_reduce_sum(z, dist.group.WORLD)
    (s * (rank + 1)).sum().backward()
    m = tdist.all_reduce_min(torch.tensor([rank, world - rank], dtype=torch.int32),
                             dist.group.WORLD)
    b = tdist.all_gather_plain(torch.tensor([rank % 2 == 0]), dist.group.WORLD)
    return g.detach().numpy(), x.grad.numpy(), r.detach().numpy(), y.grad.numpy(), \
        s.detach().numpy(), z.grad.numpy(), m.numpy(), b.numpy()


def test_collectives_and_their_gradients():
    """The autograd collectives on gloo at 3 ranks.  ``all_gather_cat``:
    the gather in rank order, its backward the reduce-scatter (an
    ``all_reduce`` and a slice on gloo) of every rank's gradient;
    ``gather_replicated``: each rank's own slice; ``all_reduce_sum``:
    forward and backward both sums over the ranks; the minimum and the
    plain gather (bool too)."""
    outs = run_ranks(_collectives_worker, 3)
    w = np.arange(18.0).reshape(9, 2) + 1.0  # the gather's loss weights
    for rank, (g, gx, r, gy, s, gz, m, b) in enumerate(outs):
        np.testing.assert_array_equal(g, np.concatenate(
            [np.arange(6.0).reshape(3, 2) + 10 * q for q in range(3)]))
        np.testing.assert_array_equal(gx, 3 * w[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(gy, (np.arange(18.0).reshape(3, 6) + 1.0)[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(r.shape, (3, 6))
        np.testing.assert_array_equal(s, [6.0, 6.0])
        np.testing.assert_array_equal(gz, [6.0, 6.0])
        np.testing.assert_array_equal(m, [0, 1])
        np.testing.assert_array_equal(b, [True, False, True])


# ---------------------------------------------------------------------------
# Sharded PTF.


def _ptf_worker(rank, world, inputs, shape, gru_vars):
    from freesplat_tpu_torch.models.networks import GRU
    from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables

    c = inputs["feats"].shape[-1]
    gru = load_flax_variables(GRU(hidden_channel=c), gru_vars).eval()
    with torch.no_grad():
        s = fuse_views_sharded(**{k: torch.from_numpy(a) for k, a in inputs.items()},
                               image_shape=shape, gru_apply=gru, group=dist.group.WORLD)
    return {k: getattr(s, k).numpy() for k in s._fields}


@pytest.mark.parametrize("views", [2, 4])
def test_fuse_views_sharded_matches_jax(views):
    """``fuse_views_sharded`` at 2 ranks with 1 and 2 views a rank against
    JAX's single-device ``fuse_views`` on the same inputs and GRU weights
    (``tests/test_torch_encoder.py::_ptf_inputs``): the valid slots equal,
    every field of them within 1e-5, as the port's ``fuse_views``."""
    import jax.numpy as jnp
    from freesplat_tpu.models import networks as jnet
    from freesplat_tpu.models import ptf as jptf
    from tests.test_torch_encoder import _ptf_inputs, jax_variables

    inputs, shape = _ptf_inputs(v=views, seed=20 + views)
    jg = jnet.GRU(hidden_channel=8)
    var = jax_variables(jg, jnp.zeros((1, 8)), jnp.zeros((1, 8)), jnp.zeros((1, 24)),
                        jnp.zeros((1, 24)), seed=11)
    js = jptf.fuse_views(**{k: jnp.asarray(a) for k, a in inputs.items()}, image_shape=shape,
                         gru_apply=lambda *a: jg.apply(var, *a))
    valid = np.asarray(js.valid)
    assert 0 < (~valid).sum() and (~valid[shape[0] * shape[1]:]).sum() > 0  # pixels merged
    for out in run_ranks(_ptf_worker, 2, inputs, shape, var):
        np.testing.assert_array_equal(out["valid"], valid)
        for f in ("feat", "coords", "density", "weight", "depth", "extrinsics"):
            np.testing.assert_allclose(out[f][valid], np.asarray(getattr(js, f))[valid],
                                       rtol=1e-5, atol=1e-5, err_msg=f)


def test_fuse_views_sharded_alone_is_fuse_views():
    """With no group, ``fuse_views_sharded`` is the port's ``fuse_views``
    bit for bit (one buffer; the same z-buffer, winners and GRU rows)."""
    from freesplat_tpu_torch.models.networks import GRU
    from freesplat_tpu_torch.models.ptf import fuse_views
    from tests.test_torch_encoder import _ptf_inputs

    inputs, shape = _ptf_inputs(v=3, seed=5)
    gru = GRU(hidden_channel=8).eval()
    t = {k: torch.from_numpy(a) for k, a in inputs.items()}
    with torch.no_grad():
        a = fuse_views(**t, image_shape=shape, gru_apply=gru)
        b = fuse_views_sharded(**t, image_shape=shape, gru_apply=gru)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_render_slabs_assemble_to_rasterize():
    """The slabs of a 4-way split, composited in one process, side by side
    equal ``rasterize``'s image bit for bit at the same budget (as the card
    checks at 384x512), and the screen gather with no group is the
    identity."""
    scene = make_scene(seed=9)
    means, cov, harm, opac = (torch.from_numpy(a) for a in scene)
    bg = torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        want = tras.rasterize(means, cov, harm, opac, torch.eye(4), torch.from_numpy(INTR),
                              (H, W), bg, 1, capacity=4096)
        screen = trend.preprocess_gaussians(means, cov, harm, opac, torch.eye(4),
                                            torch.from_numpy(INTR), (H, W), 1)
        assert all(torch.equal(x, y) for x, y in zip(gather_screen(screen, None), screen))
        slabs = [render_slab(screen, r, 4, (H, W), 4096)[0] for r in range(4)]
        got = tras.finish_image(torch.cat(slabs, dim=1), (H, W), bg)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Launch specs and batch helpers (one process).


def test_launch_spec_from_the_environment(monkeypatch):
    """``maybe_initialize_distributed`` reads JAX's coordinator variables
    and torchrun's: none (or ``FREESPLAT_DISTRIBUTED=0``) is one process;
    a partial set of either, or ``FREESPLAT_DISTRIBUTED=1`` with none,
    raises; ``make_group`` refuses a device count other than the world
    size; the scaling bench, like every entry point, asks for the GPU."""
    from freesplat_tpu_torch.parallel import scaling_bench

    names = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES",
             "JAX_NUM_PROCESSES", "PROCESS_ID", "JAX_PROCESS_ID", "RANK", "WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "FREESPLAT_DISTRIBUTED")
    for name in names:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    assert tdist.maybe_initialize_distributed("cpu") is False
    assert tdist.make_group("auto") is None and tdist.make_group(1) is None
    with pytest.raises(ValueError, match="world size is 1"):
        tdist.make_group(4)
    monkeypatch.setenv("FREESPLAT_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="no launch spec"):
        tdist.maybe_initialize_distributed("cpu")
    monkeypatch.setenv("FREESPLAT_DISTRIBUTED", "0")
    monkeypatch.setenv("RANK", "0")
    assert tdist.maybe_initialize_distributed("cpu") is False
    monkeypatch.delenv("FREESPLAT_DISTRIBUTED")
    with pytest.raises(RuntimeError, match=r"torchrun.*WORLD_SIZE"):
        tdist.maybe_initialize_distributed("cpu")
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="PROCESS_ID"):
        tdist.maybe_initialize_distributed("cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tdist.rank_device("cuda") == torch.device("cuda", 3)
    assert tdist.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        scaling_bench.main(["--gaussians", "64"])


def test_local_batch_and_pad_views():
    """``local_batch`` keeps rank r's equal share of every array's and
    list's leading axis (and refuses a batch that does not split);
    ``pad_views`` repeats the last view up to a multiple."""
    batch = {"scene": ["a", "b", "c", "d"], "context": {"image": np.arange(8).reshape(4, 2)},
             "step": 3}
    part = tdist.local_batch(batch, 1, 2)
    assert part["scene"] == ["c", "d"] and part["step"] == 3
    np.testing.assert_array_equal(part["context"]["image"], [[4, 5], [6, 7]])
    with pytest.raises(ValueError, match="does not split"):
        tdist.local_batch(batch, 0, 3)
    ctx = {"image": torch.arange(6.0).reshape(1, 3, 2), "near": torch.ones(1, 3)}
    padded, v = tdist.pad_views(ctx, 4)
    assert v == 3 and padded["image"].shape == (1, 4, 2)
    assert torch.equal(padded["image"][:, 3], ctx["image"][:, 2])
    assert tdist.pad_views(ctx, 3) == (ctx, 3)


def _scaling_worker(rank, world):
    from freesplat_tpu_torch.parallel import scaling_bench

    return scaling_bench.bench_group(dist.group.WORLD, (32, 64), 512, reps=1, device="cpu")


def test_scaling_bench_runs_on_two_ranks():
    """``bench_group`` at 2 ranks (a 32x64 view of 512 Gaussians, one
    timed step): rays/s and ms a step, nothing dropped, the same
    configuration reported by both ranks."""
    outs = run_ranks(_scaling_worker, 2)
    for out in outs:
        assert out["devices"] == 2 and out["rays_per_s"] > 0 and out["ms_per_step"] > 0
