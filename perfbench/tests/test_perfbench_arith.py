"""The trace reduction, the shares of peak and the rasterizer's pair count
on hand-made cases."""
import math

import pytest
import torch

from perfbench import harness, trace
from perfbench.metrics import _share
from perfbench.reference import render
from perfbench.roofline import peaks, raster


def iv(name, a, b):
    return trace.Interval(name, a, b)


def test_union_and_idle_share():
    device = [iv("k1", 0.1, 0.35), iv("k2", 0.25, 0.4), iv("copy", 0.6, 0.7), iv("late", 1.5, 2.0)]
    assert trace.union(device, 0.0, 1.0) == [(0.1, 0.4), (0.6, 0.7)]
    s = trace.summarize(device, 0.0, 1.0)
    assert s["busy_s"] == pytest.approx(0.4) and s["idle_share"] == pytest.approx(0.6)
    gaps = dict((round(g, 6), name) for name, g in s["idle_gaps"])
    assert gaps[0.3] == "host, after copy before the end"  # 0.7-1.0: "late" lies past it
    assert gaps[0.2] == "host, after k2 before copy"  # 0.4-0.6
    assert gaps[0.1] == "host, after the start before k1"
    assert [n for n, _ in s["device_ops"]][:2] == ["k1", "k2"]


def test_gap_labelled_by_neighbours_without_host_events():
    device = [iv("void foo<float>(int)", 0.0, 0.1), iv("bar(float*)", 0.5, 0.6)]
    s = trace.summarize(device, 0.0, 0.6)
    assert s["idle_gaps"][0][0] == "host, after foo before bar"
    assert trace.launches(s, "bar", 3) == [pytest.approx(0.1)]


def test_stretch_without_marks_is_an_error(monkeypatch):
    stretch = trace.Stretch()
    stretch.cuda = True  # a card's trace that holds no marker kernel
    monkeypatch.setattr(stretch.prof, "events", lambda: [])
    with pytest.raises(RuntimeError, match="marker"):
        stretch.reduce()


def test_mfu_and_roofline_arithmetic():
    kernels = [(0.0, 2e-3, "composite_bwd(x)"), (1.0, 1.001, "composite_bwd(x)"),
               (2.0, 9.0, "composite_bwd(x)")]
    run = harness.Run(entry="fit", model_flops_per_unit=67e12 * 0.5,
                      profile={"units": 2, "window_s": 4.0, "idle_share": 0.25,
                               "kernels": kernels},
                      raster={"bwd": {"flops": 67e9, "bytes": 0.0, "launches": 2}})
    assert _share.mfu(run, "fit") == pytest.approx(25.0)  # 2 x 0.5 s of peak in 4 s
    assert _share.idle_share(run, "fit") == pytest.approx(25.0)
    # 1 ms of bound over the first two launches' 3 ms
    assert _share.roofline(run, "fit", "bwd", "composite_bwd") == pytest.approx(100 / 3)
    assert _share.roofline(run, "run_test", "bwd", "composite_bwd") is None
    assert _share.roofline(run, "fit", "bwd", "other_kernel") is None
    assert peaks.bound_seconds(0.0, 3.35e12) == pytest.approx(1.0)


def _screen(n=60, h=40, w=56, seed=0):
    g = torch.Generator().manual_seed(seed)
    mean = torch.rand(n, 2, generator=g) * torch.tensor([w + 20.0, h + 20.0]) - 10
    a = 0.02 + torch.rand(n, generator=g) * 0.3
    c = 0.02 + torch.rand(n, generator=g) * 0.3
    b = (torch.rand(n, generator=g) - 0.5) * 0.8 * torch.sqrt(a * c)
    op = 0.2 + 0.79 * torch.rand(n, generator=g)
    mid = 0.5 * (a + c)
    lam_min = mid - torch.sqrt(torch.clamp(mid * mid - (a * c - b * b), min=0.0))
    radii = torch.ceil(3.0 / torch.sqrt(lam_min))  # 3 sigma along the long axis
    depths = torch.rand(n, generator=g) * 5 + 0.5
    depths[5] = depths[6]  # a tie, broken by index
    return {"means2d": mean, "conics": torch.stack([a, b, c], -1), "opacities": op,
            "colors": torch.rand(n, 3, generator=g), "depths": depths,
            "radii": radii, "mask": torch.rand(n, generator=g) > 0.1}


def _brute(screen, h, w):
    """Pixel by pixel, with Python floats: the pairs the rules visit."""
    th, tw = -(-h // 16), -(-w // 16)
    n = screen["depths"].shape[0]
    rect = []
    for i in range(n):
        mx, my = screen["means2d"][i].tolist()
        r = float(screen["radii"][i])
        rect.append((min(max(math.floor((mx - r) / 16), 0), tw),
                     min(max(math.floor((my - r) / 16), 0), th),
                     min(max(math.floor((mx + r + 15) / 16), 0), tw),
                     min(max(math.floor((my + r + 15) / 16), 0), th)))
    order = sorted(range(n), key=lambda i: (float(screen["depths"][i]), i))
    counts = dict(evaluated=0, blended=0, stopped=0, walked=0)
    color = torch.zeros(h, w, 3, dtype=torch.float64)
    for y in range(h):
        for x in range(w):
            t, last = 1.0, 0
            listed = [i for i in order if bool(screen["mask"][i])
                      and rect[i][0] <= x // 16 < rect[i][2] and rect[i][1] <= y // 16 < rect[i][3]]
            for j, i in enumerate(listed):
                counts["evaluated"] += 1
                mx, my = screen["means2d"][i].tolist()
                ca, cb, cc = screen["conics"][i].tolist()
                dx, dy = x - mx, y - my
                power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                alpha = min(float(screen["opacities"][i]) * math.exp(power), 0.99)
                if power > 0 or alpha < 1 / 255:
                    continue
                if t * (1 - alpha) < 1e-4:
                    counts["stopped"] += 1
                    break
                color[y, x] += alpha * t * screen["colors"][i].double()
                t *= 1 - alpha
                counts["blended"] += 1
                last = j + 1
            counts["walked"] += last
    return color, counts


def test_pair_count_against_brute_force():
    h, w = 40, 56
    screen = _screen(h=h, w=w)
    (color, _, _), counts = render.composite(screen, (h, w), torch.zeros(3), count_pairs=True)
    want_color, want = _brute(screen, h, w)
    for key in want:
        assert counts[key] == want[key], key
    assert torch.allclose(color.double(), want_color, atol=1e-5)
    assert counts["pixels"] == h * w and counts["rows"] <= int(screen["mask"].sum())
    flops, nbytes = raster.forward(counts)
    assert flops == 16 * want["evaluated"] + 13 * want["blended"] + 4 * want["stopped"]
    assert nbytes == counts["rows"] * 40 + h * w * 20
    assert raster.backward(counts)[0] == 52 * want["walked"]
