"""The ``run_test`` entry: FreeSplat evaluation as ``main.test`` runs it.

Set-up draws the weights and the scene pool from the seed and the port's
LPIPS module.  One ``run_test`` call, with ``state=`` the drawn weights,
takes its scenes from a feed that first hands out ``warmup_units`` scenes,
then synchronizes, stamps the window's start and hands out scenes until
the deadline; the window ends when ``run_test`` returns, after the last
scene's files and ``stats.json`` are written.  Every scene gets a name of
its own, so no file is written twice.  A traced run makes a second call:
the first runs ``profile_units`` scenes under the profiler after the
warm-up, the second a window's length with ``timings=``.

Compared with the reference (``reference/steps.py::eval_scene``, once per
pool scene) for every scene of the window: the colour PNGs as written
(mean absolute difference in 8-bit levels, the worst image), and the
scene's PSNR, SSIM and LPIPS in ``stats.json``; a scene that dropped
rasterizer instances fails.
"""
from __future__ import annotations

import contextlib
import json
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..harness import Cell, Check, Run
from ..reference.render import render_view
from ..reference.steps import eval_scene
from ..roofline import flops as flop_count
from ..roofline import raster
from ..scenes import make_pool, to_device
from ..trace import Stretch
from . import common


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        return _run(cell, seed, seconds, trace, device, t_start, Path(tmp))


def _run(cell, seed, seconds, trace, device, t_start, out_dir: Path) -> Run:
    from freesplat_tpu_torch.evaluation.harness import run_test

    o, tr = cell.config["overrides"], cell.traffic
    cfg = common.port_config(cell, (f"test.output_path={out_dir}",))
    result = Run(entry="run_test", chunks_per_scene=-(-tr["context_views"] // o["test.encode_view_chunk"]))
    result.mark("start and imports")
    enc_sd, lp_sd = common.draw_weights(cell, seed, device)
    enc_sd = {k: v.cpu() for k, v in enc_sd.items()}  # kept off the device for the reference
    lp_sd = {k: v.cpu() for k, v in lp_sd.items()}
    result.mark("weights")
    pool = make_pool(tr, o, seed, device)
    result.mark("scene pool")
    lpips = common.port_lpips(lp_sd, device)
    per_scene: dict[str, dict] = {}

    def name(item, k):
        return {**item, "scene": [f"u{k:04d}-{item['scene'][0]}"]}

    def test_call(feed, timings=None):
        run_test(cfg, batches=iter(feed), state=enc_sd, lpips=lpips, device=device,
                 timings=timings)
        for entry in json.loads((out_dir / "stats.json").read_text())["per_scene"]:
            per_scene[entry["scene"]] = entry

    peaks = []

    def window_start(k):
        result.mark("warm-up scenes")
        peaks.append(common.peak_bytes(device))
        common.reset_peak(device)

    def first_unit(k):
        if k == 0:
            result.mark("program set-up in run_test")

    snapshot = {}
    if trace:
        stretch = Stretch()

        def begin(k):
            window_start(k)
            snapshot["unit"] = k
            stretch.begin()

        feed = common.Feed(pool, 0, tr["warmup_units"], None, device,
                           limit=tr["profile_units"], on_start=begin, on_unit=first_unit,
                           name=name)
        test_call(feed)
        stretch.end()
        result.setup_s = feed.start - t_start
        result.profile = stretch.reduce()
        result.profile["units"] = feed.handed
        result.profile["host_s"] = stretch.host_s
        result.notes.append(f"profiled stretch: {1000 * stretch.host_s / feed.handed!r} ms a unit "
                            f"over {feed.handed} units")
        result.timings = {}
        feed = common.Feed(pool, feed.units[-1] + 1, 0, seconds, device, name=name)
        test_call(feed, timings=result.timings)
    else:
        feed = common.Feed(pool, 0, tr["warmup_units"], seconds, device,
                           on_start=window_start, on_unit=first_unit, name=name)
        test_call(feed)
        result.setup_s = feed.start - t_start
    common.sync(device)
    t_end = time.perf_counter()
    result.notes.append(common.unit_note(feed, t_end))
    result.notes.append(result.setup_note(t_start))
    result.window_s = t_end - feed.start
    result.units = result.attempted = feed.handed
    result.peak_window_bytes = common.peak_bytes(device)
    result.peak_process_bytes = max(peaks + [result.peak_window_bytes])
    judged = [(f"u{k:04d}-pool{k % len(pool)}", k % len(pool)) for k in feed.units]
    entries = [per_scene.get(s) for s, _ in judged]
    result.failed = sum(1 for e in entries if e is None or _bad(e))

    del lpips
    common.free(device)
    ref_enc, ref_lp = common.load_reference(cell, enc_sd, lp_sd, device)
    refs = {}
    counter = flop_count.counter() if trace else None
    for j in sorted({j for _, j in judged}):
        batch = {k: to_device(pool[j][k], device) for k in ("context", "target")}
        with (counter if (counter is not None and not refs) else contextlib.nullcontext()):
            color, metrics = eval_scene(ref_enc, ref_lp, batch, o["test.encode_view_chunk"])
        refs[j] = (_quantize(color), metrics)
    if trace:
        result.model_flops_per_unit = flop_count.total(counter)
        result.raster = _raster_work(ref_enc, pool[snapshot["unit"] % len(pool)], o, device)
    result.checks = compare(out_dir, judged, entries, refs, cell.workload["limits"])
    return result


def _bad(entry: dict) -> bool:
    return entry.get("dropped_instances", 0) > 0 or not all(
        math.isfinite(entry.get(k, float("nan"))) for k in ("psnr", "ssim", "lpips"))


def _quantize(color: torch.Tensor) -> np.ndarray:
    """As the program writes a PNG: clip to [0, 1], times 255, truncated."""
    return (np.clip(color.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def compare(out_dir: Path, judged, entries, refs, limits) -> list[Check]:
    level, psnr, ssim, lpips, dropped = 0.0, 0.0, 0.0, 0.0, 0.0
    for (scene, j), entry in zip(judged, entries):
        ref_png, ref = refs[j]
        if entry is None:
            level = psnr = float("inf")
            continue
        for vi in range(ref_png.shape[0]):
            path = out_dir / scene / "color" / f"{vi:04}.png"
            got = np.asarray(Image.open(path)).astype(np.int16) if path.exists() else None
            gap = (float("inf") if got is None or got.shape != ref_png[vi].shape
                   else float(np.abs(got - ref_png[vi]).mean()))
            level = max(level, gap)
        psnr = max(psnr, abs(entry["psnr"] - ref["psnr"]))
        ssim = max(ssim, abs(entry["ssim"] - ref["ssim"]))
        lpips = max(lpips, abs(entry["lpips"] - ref["lpips"]) / abs(ref["lpips"]))
        dropped += entry.get("dropped_instances", 0)
    return [
        Check("png_levels", level, limits["png_levels"]),
        Check("psnr_db", psnr, limits["psnr_db"]),
        Check("ssim", ssim, limits["ssim"]),
        Check("lpips_rel", lpips, limits["lpips_rel"]),
        Check("dropped", float(dropped), 0.0),
    ]


@torch.no_grad()
def _raster_work(ref_enc, batch, o, device) -> dict:
    """Operations and bytes of the forward kernel over one scene's views."""
    ctx, tgt = (to_device(batch[k], device) for k in ("context", "target"))
    gaussians = ref_enc.encode(ctx, o["test.encode_view_chunk"])
    image_shape = tuple(tgt["image"].shape[2:4])
    flops = nbytes = 0.0
    views = tgt["image"].shape[1]
    for i in range(views):
        counts = render_view(gaussians, tgt["extrinsics"][0, i], tgt["intrinsics"][0, i],
                             tgt["near"][0, i], image_shape, ref_enc.sizes.sh_degree,
                             count_pairs=True)[3]
        f, b = raster.forward(counts)
        flops, nbytes = flops + f, nbytes + b
    return {"fwd": {"flops": flops, "bytes": nbytes, "launches": views}}
