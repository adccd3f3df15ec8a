"""The rasterizer kernels' per-warp cull, on the CPU.

Both CUDA kernels give each warp an 8x4 pixel block and skip the
(warp, instance) pairs that ``ops/rasterizer.py::warp_cull_mask_plain``
(the plain version of ``csrc/tile_cull.cuh``) rules out.  The cull is only
right if it never rules out a pair that the compositors' per-pair cut
(power <= 0, alpha >= 1/255) would keep.  Checked here by brute force on
every case of ``tests/test_torch_render.py::CASES`` and on fuzzed
instances; the warp-step counters are checked against a count made lane
by lane; and ``rasterize`` through a compositor that applies the cull as
the kernels do (each warp sees only its own instances) still matches the
JAX rasterizer's outputs and ``jax.grad`` at the repo's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from freesplat_tpu.ops import rasterizer as jras
from freesplat_tpu_torch.ops import rasterizer as tras
from freesplat_tpu_torch.utils import cuda_build
from tests.test_torch_raster_grad import GRAD_CASES, GRAD_TOL, LEAVES, _case_inputs, _instances
from tests.test_torch_render import CASES

ALPHA_MIN32 = float(np.float32(1.0 / 255.0))
_ulp_below, _ulp_above = (float(np.nextafter(np.float32(ALPHA_MIN32), np.float32(x)))
                          for x in (0.0, 1.0))


def _passes(inst, tile_start, tile_count, tiles_x):
    """(k, 256) bool: the compositors' cut test, with their arithmetic, for
    every instance row at every pixel of its own tile."""
    tile = tras._row_tiles(tile_start, tile_count, inst.shape[0])
    px, py = tras._pixel_coords(tile_start.shape[0], tiles_x, inst.device)
    d = inst
    dx = px[tile] - d[:, 0:1]
    dy = py[tile] - d[:, 1:2]
    power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) - d[:, 3:4] * dx * dy
    alpha = torch.clamp(d[:, 5:6] * torch.exp(power), max=tras.ALPHA_MAX)
    return ~((power > 0.0) | (alpha < tras.ALPHA_MIN))


def _assert_conservative(inst, tile_start, tile_count, tiles_x):
    mask = tras.warp_cull_mask_plain(inst, tile_start, tile_count, tiles_x)
    assert mask.shape == (inst.shape[0], 8) and mask.dtype == torch.bool
    need = _passes(inst, tile_start, tile_count, tiles_x)[:, tras.warp_pixels()].any(-1)
    missed = need & ~mask
    assert not bool(missed.any()), (
        f"the cull drops {int(missed.sum())} (instance, warp) pairs that pass the cut, "
        f"e.g. row {inst[missed.any(1)][0].tolist()}")
    return mask, need


def test_warp_pixels_are_8x4_blocks_covering_the_tile():
    pix = tras.warp_pixels()
    assert pix.shape == (8, 32)
    assert sorted(pix.flatten().tolist()) == list(range(256))
    for w in range(8):
        rows, cols = pix[w] // 16, pix[w] % 16
        assert sorted(set(cols.tolist())) == list(range(8 * (w % 2), 8 * (w % 2) + 8))
        assert sorted(set(rows.tolist())) == list(range(4 * (w // 2), 4 * (w // 2) + 4))
        # Lanes in row-major order within the block (the kernels' l % 8, l / 8).
        assert pix[w].tolist() == sorted(pix[w].tolist())


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_cull_mask_keeps_every_pair_that_passes_the_cut(case):
    inst, binning, tiles_x = _instances(case)
    mask, need = _assert_conservative(inst, binning.tile_start, binning.tile_count, tiles_x)
    if case.startswith("random"):  # and it does cull: large splats, yet a fifth goes
        assert int(mask.sum()) <= 0.8 * mask.numel()
        assert int(need.sum()) <= int(mask.sum())


def _fuzz_rows(draw_rows):
    """(k, 10) float32 rows from hypothesis-drawn (mx, my, a, b, c, op)."""
    rows = np.zeros((len(draw_rows), 10), np.float32)
    rows[:, :6] = np.asarray(draw_rows, np.float64).astype(np.float32)
    rows[:, 6:] = 0.5
    return torch.from_numpy(rows)


def _conic_from_axes(sx, sy, theta):
    """Conic (a, b, c) of a 2D Gaussian with axis scales sx, sy (px)."""
    cs, sn = np.cos(theta), np.sin(theta)
    r = np.array([[cs, -sn], [sn, cs]])
    inv = r @ np.diag([1.0 / sx ** 2, 1.0 / sy ** 2]) @ r.T
    return float(inv[0, 0]), float(inv[0, 1]), float(inv[1, 1])


_coord = st.one_of(st.floats(-24.0, 72.0), st.floats(-1e7, 1e7),
                   st.sampled_from([16.0, 31.0, 23.5, -1.0, 48.0]))
_pd_conic = st.builds(_conic_from_axes, st.floats(0.05, 2e3), st.floats(0.05, 2e3),
                      st.floats(0.0, np.pi))
_needle = st.builds(_conic_from_axes, st.floats(0.05, 1.0), st.floats(50.0, 5e3),
                    st.floats(0.0, np.pi))
_near_singular = st.builds(lambda s, e, sign: (s, sign * s * (1.0 - e), s),
                           st.floats(1e-4, 10.0), st.floats(1e-9, 1e-2),
                           st.sampled_from([-1.0, 1.0]))
_any_conic = st.tuples(*[st.one_of(st.floats(-10.0, 10.0),
                                   st.sampled_from([0.0, np.inf, -np.inf, np.nan]))] * 3)
_opacity = st.one_of(st.floats(0.0, 1.0),
                     st.sampled_from([ALPHA_MIN32, _ulp_below, _ulp_above, 0.0, 1.0, 0.99,
                                      np.nan]))
_row = st.builds(lambda mx, my, abc, op: (mx, my, *abc, op), _coord, _coord,
                 st.one_of(_pd_conic, _needle, _near_singular, _any_conic), _opacity)


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_row, min_size=1, max_size=6))
def test_cull_mask_fuzz_is_conservative(rows):
    """Needles, near-singular and non-PD conics, opacity at and around
    1/255, far and non-finite fields: all in the centre tile of a 3x3
    grid, tested at the tile's pixels by brute force."""
    inst = _fuzz_rows(rows)
    k = inst.shape[0]
    tile_count = torch.zeros(9, dtype=torch.int32)
    tile_count[4] = k
    tile_start = torch.tensor([0] * 5 + [k] * 4, dtype=torch.int32)
    mask, _ = _assert_conservative(inst, tile_start, tile_count, 3)
    op = inst[:, 5]
    finite = torch.isfinite(inst[:, :6]).all(1)
    assert not bool(mask[finite & (op < ALPHA_MIN32)].any())  # can pass nowhere
    assert bool(mask[~finite].all())  # cannot be trusted: culls nothing


def _brute_steps(inst, binning, tiles_x, walk):
    """The warp-steps, simulated lane by lane, tile by tile."""
    ts, tc = binning.tile_start, binning.tile_count
    passes = _passes(inst, ts, tc, tiles_x).numpy()
    mask = tras.warp_cull_mask_plain(inst, ts, tc, tiles_x).numpy()
    lanes = tras.warp_pixels().numpy()
    walk = walk.numpy()
    got = dict(fwd=0, fwd_cull=0, bwd_tile_start=0, bwd=0, bwd_cull=0, bwd_reducing=0,
               fwd_cull_warp_max=0, bwd_cull_warp_max=0)
    for t in range(ts.shape[0]):
        s, n = int(ts[t]), min(int(tc[t]), tras.MAX_TILE_INSTANCES)
        got["bwd_tile_start"] += 8 * int(walk[t].max())
        for w in range(8):
            wl = walk[t, lanes[w]]
            alive = np.ones(32, bool)
            fwd_visits = bwd_visits = 0
            for j in range(n):
                if not alive.any():
                    break
                got["fwd"] += 1
                fwd_visits += int(mask[s + j, w])
                # A live lane stops at the first instance at or past its walk that passes.
                alive &= ~(passes[s + j, lanes[w]] & (j >= wl))
            for j in range(int(wl.max())):
                got["bwd"] += 1
                bwd_visits += int(mask[s + j, w])
                got["bwd_reducing"] += int((passes[s + j, lanes[w]] & (j < wl)).any())
            got["fwd_cull"] += fwd_visits
            got["bwd_cull"] += bwd_visits
            got["fwd_cull_warp_max"] = max(got["fwd_cull_warp_max"], fwd_visits)
            got["bwd_cull_warp_max"] = max(got["bwd_cull_warp_max"], bwd_visits)
    return got


@pytest.mark.parametrize("case", ["dense_overlap", "random_s1", "capacity_clamp", "culled"])
def test_warp_step_counters_match_a_lane_by_lane_count(case):
    inst, binning, tiles_x = _instances(case)
    args = (inst, binning.tile_start, binning.tile_count, tiles_x)
    out, walk = tras.composite_tiles_plain(*args)
    steps = tras.warp_steps_plain(*args, walk)
    brute = _brute_steps(inst, binning, tiles_x, walk)
    assert {k: steps[k] for k in brute} == brute
    cnt = binning.tile_count.long()
    assert steps["tiles"] == cnt.shape[0]
    assert steps["tile_count_max"] == int(cnt.max())
    assert steps["tile_walk_max"] == int(walk.max())
    assert steps["fwd_cull"] <= steps["fwd"] and steps["bwd_cull"] <= steps["bwd"]
    assert steps["bwd"] <= steps["bwd_tile_start"]
    if case == "dense_overlap":  # pixels terminate: the forward stops before the tiles end
        assert steps["fwd"] < 8 * int(cnt.sum())


def _culled_composite(inst, tile_start, tile_count, tiles_x):
    """``composite_tiles`` as the kernels apply the cull: warp w's pixels
    see only the instances whose mask bit w is set (the others get
    opacity 0, which the cut rejects as the kernels skip them)."""
    mask = tras.warp_cull_mask_plain(inst.detach(), tile_start, tile_count, tiles_x)
    outs = []
    for w in range(8):
        op = torch.where(mask[:, w], inst[:, 5], torch.zeros_like(inst[:, 5]))
        inst_w = torch.cat([inst[:, :5], op[:, None], inst[:, 6:]], dim=1)
        outs.append(tras.composite_tiles(inst_w, tile_start, tile_count, tiles_x))
    owner = torch.empty(tras.P, dtype=torch.long)
    owner[tras.warp_pixels().flatten()] = torch.arange(tras.P) // 32
    return torch.stack(outs)[owner, :, torch.arange(tras.P)].permute(1, 0, 2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_culled_rasterize_matches_jax(case):
    (means, cov, harm, opac), cams, shape, bg, kw, cot = _case_inputs(case)
    atol_c, atol_d = CASES[case][5:7]

    def jloss(m, c, h, o):
        color, depth, alpha = jras.rasterize(m, c, h, o, jnp.asarray(cams[0]),
                                             jnp.asarray(cams[1]), shape, jnp.asarray(bg), 1, **kw)
        loss = (jnp.sum(color * cot[0]) + jnp.sum(depth * cot[1]) + jnp.sum(alpha * cot[2]))
        return loss, (color, depth, alpha)

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *[jnp.asarray(a) for a in (means, cov, harm, opac)])
    xs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (means, cov, harm, opac)]
    cam = [torch.from_numpy(c) for c in cams]
    capacity = kw.get("capacity")
    tout = tras._rasterize(_culled_composite, *xs, *cam, shape, torch.from_numpy(bg), 1,
                           capacity, False)
    with torch.no_grad():
        plain = tras.rasterize(*[x.detach() for x in xs], *cam, shape, torch.from_numpy(bg), 1,
                               capacity=capacity)
    for name, a, b, p, tol in zip(("color", "depth", "alpha"), tout, jout, plain,
                                  (atol_c, atol_d, atol_c)):
        assert torch.equal(a.detach(), p), f"{case} {name}: the cull changed the output"
        # As test_torch_render: depth gets a relative term on the fuzz scenes.
        rtol = 1e-5 if name == "depth" and case.startswith("fuzz") else 0.0
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=tol, rtol=rtol,
                                   err_msg=f"{case} {name}")
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cot))
    loss.backward()
    for name, x, g in zip(LEAVES, xs, jgrads):
        a, b = x.grad.numpy(), np.asarray(g)
        assert np.isfinite(a).all(), f"{case} {name}: non-finite"
        scale = np.abs(b).max()
        err = np.abs(a - b).max() / scale if scale else np.abs(a).max()
        assert err <= GRAD_TOL, f"{case} {name}: scaled error {err:.3g}"


def test_library_path_changes_with_a_header(tmp_path):
    """A kernel rebuilds when a header it may include changes: the library's
    name hashes every ``*.cuh`` beside the source (no nvcc needed)."""
    (tmp_path / "k.cu").write_text('#include "cull.cuh"\n')
    (tmp_path / "cull.cuh").write_text("// one\n")
    first = cuda_build.library_path("k", tmp_path)
    assert cuda_build.library_path("k", tmp_path) == first
    (tmp_path / "cull.cuh").write_text("// two\n")
    second = cuda_build.library_path("k", tmp_path)
    assert second != first and second.parent == first.parent
    (tmp_path / "other.cuh").write_text("// new\n")
    assert cuda_build.library_path("k", tmp_path) != second
    # The package's own kernels hash csrc/tile_cull.cuh, which both include.
    assert (cuda_build.CSRC / "tile_cull.cuh").exists()
    for name in ("rasterize_fwd", "rasterize_bwd"):
        assert '#include "tile_cull.cuh"' in (cuda_build.CSRC / f"{name}.cu").read_text()
