"""The span-and-counter recorder (``utils/profiling.py``) on the CPU.

The recorder's own arithmetic (nesting, parents, units, self time), its
counters (a device tensor read only at ``flush()``), that no recorder
records and allocates nothing, and the span trees of a ``fit`` step and a
chunked ``run_test`` scene: their names, ``timings=``'s keys as the phase
timers gave them, a drop planted on a step ``fit`` does not log, and the
outputs bit-equal with recording on and off.  Tiny shapes, and torch's
own initialization in place of ``init_like_flax`` (seconds on the host
for the 50 M weights): the weights' values do not matter here.
"""
import collections
import copy
import json
import time
import tracemalloc

import numpy as np
import pytest
import torch

from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.data import synthetic as tsyn
from freesplat_tpu_torch.evaluation.harness import run_test
from freesplat_tpu_torch.models import decoder as tdec
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models.adapter import GaussianAdapterCfg
from freesplat_tpu_torch.models.encoder import EncoderFreeSplatCfg
from freesplat_tpu_torch.training.trainer import TrainCfg, fit, init_state
from freesplat_tpu_torch.utils.profiling import (
    Recorder, active, annotate, count, recording, span, trace,
)
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)

RENDER = ["render.preprocess", "render.binning", "render.rows", "render.composite",
          "render.finish"]
ENCODER = ["encoder.backbone", "encoder.cost_volume", "encoder.depth_net", "encoder.ptf",
           "encoder.head"]


@pytest.fixture
def fast_init(monkeypatch):
    """Seeded torch initialization in place of the JAX package's draw."""
    def init(module, seed):
        return module

    monkeypatch.setattr(tenc, "init_like_flax", init)
    torch.manual_seed(0)


def children(tree: dict) -> dict[int, list[int]]:
    out = collections.defaultdict(list)
    for i, s in enumerate(tree["spans"]):
        out[s["parent"]].append(i)
    return out


def names(tree: dict, idx) -> list[str]:
    return [tree["spans"][i]["name"] for i in idx]


def test_recorder_nesting_units_and_self_time():
    rec = Recorder(events=False)
    with recording(rec):
        assert active() is rec
        with span("step", unit=7):
            with span("a"):
                time.sleep(0.002)
            with span("b", k=1):
                with span("c"):
                    time.sleep(0.001)
                count("n", 2)
        with span("outside"):
            count("n", 1, unit="u")
    assert active() is None
    tree = rec.flush()
    spans = tree["spans"]
    assert [s["name"] for s in spans] == ["step", "a", "b", "c", "outside"]
    assert [s["parent"] for s in spans] == [-1, 0, 0, 2, -1]
    assert [s["unit"] for s in spans] == [7, 7, 7, 7, None]
    assert spans[2]["attrs"] == {"k": 1}
    length = [s["t1_ns"] - s["t0_ns"] for s in spans]
    assert all(n > 0 for n in length)
    assert spans[0]["self_ns"] == length[0] - length[1] - length[2]
    assert spans[2]["self_ns"] == length[2] - length[3]
    assert spans[1]["self_ns"] == length[1] >= 2_000_000
    assert [(c["name"], c["value"], c["unit"], c["span"]) for c in tree["counters"]] == [
        ("n", 2, 7, 2), ("n", 1, "u", 4)]
    assert rec.totals("n") == {7: 2, "u": 1}
    assert json.loads(rec.to_json())["spans"][3]["name"] == "c"


def test_device_tensor_counter_resolves_at_flush():
    rec = Recorder(events=False)
    value = torch.tensor(3)
    with recording(rec), span("step", unit=0):
        count("dropped_instances", value)
    assert rec.counters[0].value is value  # not read before flush
    assert rec.to_dict()["counters"][0]["value"] is None
    assert rec.flush()["counters"][0]["value"] == 3
    assert rec.totals("dropped_instances") == {0: 3}


def test_no_recorder_records_and_allocates_nothing(tmp_path):
    assert active() is None
    assert span("a") is span("b", k=1)  # one shared no-op
    with span("warm"):
        count("warm", 1)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(2000):
            with span("x"):
                count("y", 1)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 512  # nothing kept per call
    rec = Recorder(events=False)
    with recording(rec):
        pass
    with span("after"):
        count("after", 1)
    assert rec.spans == [] and rec.counters == []
    # annotate is a span while recording, a record_function range alone
    # otherwise; either shows up in a profiler trace.
    with trace(str(tmp_path / "t")) as prof:
        with annotate("bare"):
            pass
        with recording(rec), annotate("recorded"):
            pass
    keys = {e.key for e in prof.key_averages()}
    assert {"bare", "recorded"} <= keys
    assert [s.name for s in rec.spans] == ["recorded"]


def _train_cfg():
    return TrainCfg(
        encoder=EncoderFreeSplatCfg(num_depth_candidates=8,
                                    adapter=GaussianAdapterCfg(sh_degree=1)),
        decoder=tdec.DecoderCfg(sh_degree=1), log_every=10,
    )


def test_fit_span_tree_timings_and_unlogged_drop(monkeypatch, fast_init):
    """One step, step 1, which ``fit`` does not log (``log_every`` 10), with
    the render capacity cut to 128 so that it drops instances."""
    cfg = _train_cfg()
    stream = tsyn.synthetic_batches(tsyn.SyntheticCfg(image_shape=(32, 32)), device="cpu")
    batch = next(stream)
    state = {**init_state(cfg, seed=3, device="cpu"), "step": 1}
    state_off = copy.deepcopy(state)
    monkeypatch.setattr(tdec, "render_capacity", lambda n, f: 128)

    rec, timings, logged, logged_off = Recorder(), {}, {}, {}
    with recording(rec):
        state = fit(cfg, state, iter([batch]), 2, log_fn=logged.__setitem__, timings=timings)
    state_off = fit(cfg, state_off, iter([batch]), 2, log_fn=logged_off.__setitem__)

    # Outputs bit-equal with recording (and timings=' syncs) on and off.
    for (k, a), (_, b) in zip(state["encoder"].state_dict().items(),
                              state_off["encoder"].state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert logged == logged_off == {}

    assert {k: len(v) for k, v in timings.items()} == {
        "forward_s": 1, "backward_s": 1, "optimizer_s": 1, "ptf_s": 1, "ptf_backward_s": 1}
    tree = rec.flush()
    kids = children(tree)
    assert names(tree, kids[-1]) == ["step"]
    root = kids[-1][0]
    views = batch["target"]["image"].shape[1]
    assert tree["spans"][root]["unit"] == 1
    assert names(tree, kids[root]) == ["step.upload", "step.forward", "loss",
                                       "step.backward", "step.optimizer"]
    fwd = kids[root][1]
    assert names(tree, kids[fwd]) == ["encoder"] + ["render"] * views
    assert names(tree, kids[kids[fwd][0]]) == ENCODER
    assert all(names(tree, kids[r]) == RENDER for r in kids[fwd][1:])

    # The drop, counted though the step is not logged.
    assert rec.totals("dropped_instances")[1] > 0
    # Every site that waits for a card, as its sync debug mode counts them.
    sites = collections.Counter()
    for c in tree["counters"]:
        if c["name"] == "host_syncs":
            sites[c["attrs"]["site"]] += c["value"]
    assert sites == {
        "step.upload": 10, "encoder.sweep_geometry": 2, "layers.interpolate_bilinear": 4,
        "adapter.scale_multiplier": 2, "ptf.project_to_view": 1, "ptf.fuse_one_view": 2,
        "projection.get_fov": 5 * views, "rendering.preprocess_gaussians": 3 * views,
        "decoder.render_view": views, "render.binning": 5 * views}
    assert rec.totals("slots") == {1: 128 * views}
    assert rec.totals("instances")[1] > 128 * views


def test_ptf_backward_span_and_counters(monkeypatch, fast_init):
    """PTF's backward is a span inside ``step.backward``, its merges and
    copies are counters; with no recorder and no ``timings=`` the step
    registers no autograd hook."""
    cfg = _train_cfg()
    batch = next(tsyn.synthetic_batches(tsyn.SyntheticCfg(image_shape=(32, 32)), device="cpu"))
    state = init_state(cfg, seed=3, device="cpu")
    hooks = []
    register = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda t, fn: hooks.append(fn) or register(t, fn))

    state = fit(cfg, state, iter([batch]), 1)
    assert hooks == []

    rec = Recorder()
    with recording(rec):
        fit(cfg, state, iter([batch]), 2)
    assert hooks
    tree = rec.flush()
    kids = children(tree)
    root = kids[-1][0]
    backward = kids[root][3]
    assert names(tree, [backward]) == ["step.backward"]
    assert names(tree, kids[backward]) == ["encoder.ptf.backward"]
    inner = tree["spans"][kids[backward][0]]
    assert inner["unit"] == 1 and inner["t0_ns"] < inner["t1_ns"]
    # Two contexts of 32x32: one fusion round, which copies the buffer's
    # two views (64 features, 22 more columns of float32, and the mask).
    hw = 32 * 32
    merged = [c for c in tree["counters"] if c["name"] == "ptf_merged"]
    assert [c["attrs"] for c in merged] == [{"view": 1}]
    assert 0 <= merged[0]["value"] <= hw
    assert rec.totals("ptf_copy_bytes") == {1: 2 * hw * ((64 + 22) * 4 + 1)}


def _scene(seed, v_ctx=4, v_tgt=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    n = v_ctx + v_tgt
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, s in enumerate(np.linspace(0.0, 1.0, n)):
        a = 0.08 * s
        extr[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        extr[i, :3, 3] = [0.3 * s, 0.0, 0.05 * s]
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (n, 1, 1))
    img = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    ctx, tgt = list(range(0, n, 2))[:v_ctx], [i for i in range(n) if i % 2][:v_tgt]
    ctx += [i for i in range(n) if i not in ctx + tgt][:v_ctx - len(ctx)]

    def views(idx):
        return {"image": img[idx][None], "extrinsics": extr[idx][None],
                "intrinsics": intr[idx][None], "near": np.full((1, len(idx)), 0.5, np.float32),
                "far": np.full((1, len(idx)), 15.0, np.float32)}

    return {"scene": [f"s{seed}"], "context": views(ctx), "target": views(tgt)}


def test_chunked_run_test_span_tree_and_timings(tmp_path, fast_init):
    args = ["+experiment=scannet/2views", "encoder.num_depth_candidates=8",
            "dataset.image_shape=[32,32]", "test.encode_view_chunk=2",
            "test.save_depth=true"]
    on_cfg = load_config(args + [f"test.output_path={tmp_path / 'on'}"])
    off_cfg = load_config(args + [f"test.output_path={tmp_path / 'off'}"])
    state = init_state(TrainCfg(encoder=on_cfg.encoder), seed=5,
                       device="cpu")["encoder"].state_dict()

    rec, timings = Recorder(), {}
    with recording(rec):
        run_test(on_cfg, batches=iter([_scene(1)]), state=state, device="cpu", timings=timings)
    run_test(off_cfg, batches=iter([_scene(1)]), state=state, device="cpu")

    # Bit-equal outputs: the stats and every PNG.
    stats = [json.loads((tmp_path / d / "stats.json").read_text()) for d in ("on", "off")]
    assert stats[0] == stats[1]
    pngs = sorted(p.relative_to(tmp_path / "on") for p in (tmp_path / "on").rglob("*.png"))
    assert len(pngs) == 2 * 2 + 4 + 4 + 2  # colour, gt, context, depth maps
    for p in pngs:
        assert (tmp_path / "on" / p).read_bytes() == (tmp_path / "off" / p).read_bytes()

    assert {k: len(v) for k, v in timings.items()} == {
        "encoder_s": 1, "decoder_s_per_view": 1, "metrics_s": 1, "dumps_s": 1,
        "A_match_s": 1, "A_geometry_s": 1, "B_trunk_s": 2, "B_concat_s": 1, "C1_ptf_s": 1,
        "C2_head_s": 1}
    tree = rec.flush()
    kids = children(tree)
    assert names(tree, kids[-1]) == ["run_test.setup", "scene", "run_test.stats"]
    scene = kids[-1][1]
    assert tree["spans"][scene]["unit"] == "s1"
    assert names(tree, kids[scene]) == ["scene.upload", "encode", "decode", "scene.metrics",
                                        "scene.readback", "scene.dumps"]
    encode, decode, _, _, dumps = kids[scene][1:]
    assert names(tree, kids[encode]) == ["encode.match", "encode.geometry", "encode.trunk",
                                         "encode.trunk", "encode.concat", "encoder.ptf",
                                         "encoder.head"]
    trunks = kids[encode][2:4]
    assert [tree["spans"][i]["attrs"]["chunk"] for i in trunks] == [0, 2]
    assert all(names(tree, kids[t]) == ENCODER[:3] for t in trunks)
    assert names(tree, kids[decode]) == ["render", "render"]
    # The scene's files go to the writer threads after a wait for the
    # previous scene's (none here); run_test.stats first waits for them.
    assert names(tree, kids[dumps]) == ["dumps.wait"]
    assert names(tree, kids[kids[-1][2]]) == ["dumps.wait"]
    pngs_counted = [c for c in tree["counters"] if c["name"].startswith("png_")]
    assert {c["unit"] for c in pngs_counted} == {"s1"}
    kinds = collections.Counter(c["attrs"]["kind"] for c in pngs_counted
                                if c["name"] == "png_ms")
    assert kinds == {"color": 2, "gt": 2, "context": 4, "depth": 6}
    hidden = [c["value"] for c in pngs_counted if c["name"] == "png_hidden"]
    assert len(hidden) == 1 and 0 <= hidden[0] <= len(pngs)
    totals = {n: sum(c["value"] for c in tree["counters"] if c["name"] == n)
              for n in ("png_files", "png_bytes")}
    assert totals["png_files"] == len(pngs)
    assert totals["png_bytes"] == sum((tmp_path / "on" / p).stat().st_size for p in pngs)
    sites = collections.Counter()
    for c in tree["counters"]:
        if c["name"] == "host_syncs":
            sites[c["attrs"]["site"]] += c["value"]
    assert sites == {
        "scene.upload": 10, "encoder.sweep_geometry": 2, "layers.interpolate_bilinear": 8,
        "adapter.scale_multiplier": 2, "ptf.project_to_view": 3, "ptf.fuse_one_view": 6,
        "projection.get_fov": 10, "rendering.preprocess_gaussians": 6,
        "decoder.render_view": 2, "render.binning": 10, "metrics.compute_ssim": 1,
        "scene.metrics": 1 + 2 + 2, "scene.readback": 5}


@pytest.mark.parametrize("name", ["step", "scene"])
def test_unit_comes_from_the_root(name):
    rec = Recorder(events=False)
    with recording(rec):
        with span(name, unit="k"):
            with span("inner"):
                count("c", 1)
    assert [s.unit for s in rec.spans] == ["k", "k"]
    assert rec.totals("c") == {"k": 1}
