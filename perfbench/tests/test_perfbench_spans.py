"""``perfbench/spans.py``'s arithmetic on synthetic intervals: busy seconds
by the device interval of the span that launched the work, idle seconds
by the innermost host span, the clock's anchor, and the metrics."""
import pytest

from perfbench import spans

NS = 1_000_000_000


def span(name, parent, t0, t1, device=None, unit=None):
    return {"name": name, "parent": parent, "unit": unit, "attrs": {},
            "t0_ns": int(t0 * NS), "t1_ns": int(t1 * NS),
            "device_at": None if device is None else list(device)}


def tree_of(*rows, counters=()):
    return {"spans": list(rows), "counters": list(counters)}


KERNELS = [(0.0, 1.0, "k"), (0.5, 2.0, "k"), (4.0, 5.0, "k"), (8.0, 9.0, "k")]


def test_busy_by_launching_span_idle_by_innermost_host_span():
    tree = tree_of(span("step", -1, 0.5, 9.5, (0.0, 9.2), unit=0),
                   span("a", 0, 0.5, 3.0, (0.0, 3.0)),
                   span("b", 0, 6.0, 9.5, (7.5, 9.2)))
    red = spans.reduce(tree, KERNELS, 0.0, 10.0, spans.Clock(0, 0.0, 0.0))
    assert red["busy_s"] == pytest.approx(4.0) and red["idle_s"] == pytest.approx(6.0)
    p = red["by_path"]
    assert [p[k]["busy_s"] for k in ("step", "step/a", "step/b")] == pytest.approx([4, 2, 1])
    assert p["step"]["own_busy_s"] == pytest.approx(1.0)  # the kernel at 4-5
    assert [p[k]["idle_s"] for k in ("step", "step/a", "step/b")] == pytest.approx([5.5, 1, 2.5])
    assert p["step"]["own_idle_s"] == pytest.approx(2.0)  # 3-4 and 5-6
    got = dict((k, v) for k, v in red["idle_by_span"])
    assert got == pytest.approx({"step/b": 2.5, "step": 2.0, "step/a": 1.0,
                                 spans.OUTSIDE: 0.5})
    assert [k for k, _ in red["idle_by_span"]] == ["step/b", "step", "step/a", spans.OUTSIDE]
    assert sum(v for _, v in red["idle_by_span"]) == pytest.approx(red["idle_s"])


def test_clock_anchor_and_host_fallback():
    """Host ns map through the anchor; a span without device times takes
    its host interval for busy too; the window clips everything."""
    base = 123 * NS
    tree = tree_of(span("x", -1, 123 + 3.5, 123 + 8.5), span("y", -1, 123 - 1.0, 123 + 0.5))
    red = spans.reduce(tree, KERNELS, 0.2, 10.0, spans.Clock(base, 0.0, None))
    x, y = red["spans"]
    assert x["host"] == pytest.approx((3.5, 8.5)) and x["device"] == x["host"]
    assert x["busy"] == pytest.approx(1.5) and x["idle"] == pytest.approx(3.5)
    assert y["busy"] == pytest.approx(0.3) and y["idle"] == pytest.approx(0.0)
    assert red["window_s"] == pytest.approx(9.8)


def test_planted_host_gap_goes_to_its_span():
    """A host-only span between two kernels takes the whole gap; the
    launch latency (the device runs after the host) shifts the edges."""
    latency = 5e-6
    kernels = [(0.0, 0.001, "a"), (0.021 + latency, 0.022 + latency, "b")]
    tree = tree_of(span("probe.sleep", -1, 0.001, 0.021))
    red = spans.reduce(tree, kernels, 0.0, 0.023, spans.Clock(0, 0.0, 0.0))
    gap = 0.020 + latency
    assert red["by_path"]["probe.sleep"]["own_idle_s"] / gap == pytest.approx(
        0.020 / gap, rel=1e-9)
    assert red["idle_by_span"][0][0] == "probe.sleep"


def test_metrics_of_both_entries():
    steps, counters = [], []
    for u in range(3):
        t = 3.0 * u
        steps.append(span("step", -1, t, t + 3, (t, t + 3), unit=u))
        root = len(steps) - 1
        steps.append(span("step.forward", root, t, t + 1, (t, t + 1)))
        steps.append(span("step.optimizer", root, t + 2, t + 3, (t + 2, t + 2.5)))
        counters += [{"name": "host_syncs", "value": n, "unit": u, "span": root,
                      "attrs": {"site": "s"}} for n in (u + 1, 8)]
    kernels = [(0.0, 0.5, "k"), (2.2, 2.4, "k"), (3.0, 3.5, "k")]
    tree = tree_of(*steps, counters=counters)
    red = spans.reduce(tree, kernels, 0.0, 9.0, spans.Clock(0, 0.0, 0.0))
    m = spans.metrics("fit", tree, red, 0.0, 9.0)
    assert m["syncs_per_step.train"] == 10  # 9, 10, 11
    assert m["optimizer_busy_ms.train"] == pytest.approx(1e3 * 0.2 / 3)
    # Idle in the forwards [0,1], [3,4], [6,7] and the optimizers [2,3], [5,6], [8,9].
    assert m["launch_idle_share.train"] == pytest.approx(100 * (0.5 + 0.8 + 0.5 + 1 + 1 + 1) / 9)

    scene = [span("scene", -1, 0.0, 9.0, (0.0, 9.0), unit="s"),
             span("encoder.cost_volume", 0, 0.0, 1.0, (0.0, 1.0)),
             span("render", 0, 2.0, 3.0, (2.0, 3.0)),
             span("render.binning", 2, 2.0, 2.5, (2.0, 2.5)),
             span("render", 0, 3.0, 4.0, (3.0, 4.0)),
             span("render.preprocess", 4, 3.0, 3.2, (3.0, 3.2)),
             span("scene.dumps", 0, 5.0, 9.0, (5.0, 9.0))]
    tree = tree_of(*scene, counters=[{"name": "host_syncs", "value": 7, "unit": "s", "span": 0,
                                      "attrs": {"site": "x"}}])
    red = spans.reduce(tree, kernels, 0.0, 9.0, spans.Clock(0, 0.0, 0.0))
    m = spans.metrics("run_test", tree, red, 0.0, 9.0)
    assert m == pytest.approx({"syncs_per_scene.serve": 7, "dumps_idle_share.serve": 100 * 4 / 9,
                               "plane_sweep_busy_ms.serve": 500.0,
                               "binning_busy_ms_per_view.serve": 1e3 * (0.2 + 0.2) / 2})
