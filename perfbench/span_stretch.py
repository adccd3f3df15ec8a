"""A cell's stretch under the program's recorder, with the device trace.

    python3 perfbench/span_stretch.py --workload <cell> --seed <n> [--probe]

Set-up and warm-up as the cell's entry makes them, then, on one program
state and in one device-only profiler session (as ``trace.Stretch``
records a traced run's stretch): a stretch of ``profile_units`` units,
the same under ``recording(rec)`` (``freesplat_tpu_torch/utils/profiling.py``),
and with ``--probe`` a 20 ms host span planted between two kernels (three times)
and a span site's cost; then,
unprofiled, one unit under ``torch.cuda.set_sync_debug_mode("warn")``
without a recorder and one with it.  Prints one JSON line: each stretch's unit
ms, the spans' metrics (``spans.metrics``), the idle seconds by innermost
span, busy and idle by span path, the counters by unit, and the sync
census (the debug mode's warnings by site against ``host_syncs``), and
how the probe's gap maps onto its span.  Nothing here compares outputs with
the reference: the cell's own runs do (``run.py``).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, spans  # noqa: E402
from perfbench.trace import MARK, MARK_CYCLES  # noqa: E402


class Session:
    """One device-only profiler session over a run's stretches (several
    sessions in one process lose events on the card).  Each stretch runs
    from a marker kernel launched right after a synchronize to one before
    its last synchronize (on the CPU a ``record_function`` range of the
    marker's name); ``begin(rec)`` also anchors ``rec``: its origin event
    and the host instant just before the marker's launch."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self.anchors: list[int] = []
        self.host_s: list[float] = []

    def _mark(self):
        import torch

        if self.cuda:
            torch.cuda._sleep(MARK_CYCLES)
        else:
            with torch.profiler.record_function(MARK):
                pass

    def begin(self, rec=None):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        if rec is not None:
            rec.origin()
        self.anchors.append(time.perf_counter_ns())
        self._mark()
        self._t0 = time.perf_counter()

    def end(self):
        import torch

        self._mark()
        if self.cuda:
            torch.cuda.synchronize()
        self.host_s.append(time.perf_counter() - self._t0)

    def close(self):
        """Stop the profiler; keep the device's intervals and the marks."""
        import torch

        self.prof.__exit__(None, None, None)
        want = torch.autograd.DeviceType.CUDA if self.cuda else torch.autograd.DeviceType.CPU
        events = [(ev.time_range.start * 1e-6, ev.time_range.end * 1e-6, ev.name,
                   bool(getattr(ev, "is_user_annotation", False)), ev.device_type == want)
                  for ev in self.prof.events()]
        self.marks = sorted(e[:2] for e in events if MARK in e[2])
        self.kernels = sorted(e[:3] for e in events
                              if e[4] and not e[3] and MARK not in e[2])
        self.annotations = [(e[2], "device" if e[4] else "host", e[0], e[1])
                            for e in events if e[3] and MARK not in e[2]]
        if len(self.marks) != 2 * len(self.anchors):
            raise RuntimeError(f"the session holds {len(self.marks)} marks for "
                               f"{len(self.anchors)} stretches")

    def window(self, i: int) -> tuple[float, float]:
        return self.marks[2 * i][0], self.marks[2 * i + 1][1]

    def busy_share(self, i: int) -> float:
        lo, hi = self.window(i)
        return sum(b - a for a, b in spans.merge(self.kernels, lo, hi)) / (hi - lo)

    def reduce(self, i: int, tree: dict) -> tuple[dict, float, float]:
        lo, hi = self.window(i)
        clock = spans.Clock(self.anchors[i], lo, lo if self.cuda else None)
        return spans.reduce(tree, self.kernels, lo, hi, clock), lo, hi


def sync_census(call) -> dict:
    """``call(wrap)`` with ``wrap`` turning the sync debug mode "warn" on
    while each unit runs (from its hand-out to the next one's): the
    warnings by site (file:line) and in all."""
    import torch

    def wrap(units):
        for unit in units:
            torch.cuda.set_sync_debug_mode("warn")
            yield unit
            torch.cuda.set_sync_debug_mode(0)

    sites: collections.Counter = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            call(wrap)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchronizing" in str(w.message):
            sites[f"{Path(w.filename).name}:{w.lineno}"] += 1
    return {"warnings": sum(sites.values()), "sites": dict(sites.most_common())}


def probe(session: Session, device) -> tuple[dict, int]:
    """A stretch of ``session`` holding a 20 ms host-only span between two
    kernels: the recorder's spans, and the host clock just before the
    second kernel's launch."""
    import torch

    from freesplat_tpu_torch.utils.profiling import Recorder, recording, span

    x = torch.zeros(1 << 20, device=device)
    rec = Recorder()
    with recording(rec):
        session.begin(rec)
        x.add_(1)
        with span("probe.sleep"):
            time.sleep(0.02)
        launch = time.perf_counter_ns()
        x.add_(1)
        session.end()
    return rec.flush(), launch


def probe_result(session: Session, i: int, tree: dict, launch: int) -> dict:
    """The probe's idle gap, the share of it its span gets, the error of
    the span's edges against the gap's, and the second kernel's start
    after the host reached its launch."""
    red, lo, hi = session.reduce(i, tree)
    h0, h1 = red["spans"][0]["host"]
    kernels = [k for k in session.kernels if lo <= k[0] and k[1] <= hi]
    gaps = [(a[1], b[0]) for a, b in zip(kernels, kernels[1:]) if b[0] > a[1]]
    g0, g1 = max(gaps, key=lambda g: min(g[1], h1) - max(g[0], h0))
    clock = spans.Clock(session.anchors[i], lo)
    return {"gap_ms": 1e3 * (g1 - g0), "span_ms": 1e3 * (h1 - h0),
            "attributed_share": red["by_path"]["probe.sleep"]["own_idle_s"] / (g1 - g0),
            "start_edge_ms": 1e3 * (h0 - g0), "end_edge_ms": 1e3 * (h1 - g1),
            "launch_to_start_ms": 1e3 * (g1 - clock.host(launch)),
            "idle_by_span": red["idle_by_span"]}


def span_cost(recorded: bool, n: int = 20000) -> float:
    """Host microseconds a span site costs: ``n`` empty spans, with no
    recorder or with one (its events, and under an active profiler its
    ``record_function`` ranges)."""
    from freesplat_tpu_torch.utils.profiling import Recorder, recording, span

    rec = Recorder() if recorded else None
    with recording(rec):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("cost"):
                pass
        seconds = time.perf_counter() - t0
    if rec is not None:
        rec.flush()
    return 1e6 * seconds / n


def counters_by_unit(tree: dict) -> dict:
    out: dict = collections.defaultdict(dict)
    for c in tree["counters"]:
        key = c["name"] + ("@" + c["attrs"]["site"] if "site" in c["attrs"] else "")
        unit = str(c["unit"])
        out[unit][key] = out[unit].get(key, 0) + (c["value"] or 0)
    return out


def run(cell, seed: int, device, out_dir: Path, probe_too: bool = False) -> dict:
    """The stretches of ``cell`` (a whole scene's files go to ``out_dir``)."""
    import torch

    from freesplat_tpu_torch.utils.profiling import Recorder, recording

    from perfbench.entries import common
    from perfbench.scenes import make_pool

    tr = cell.traffic
    units = tr["profile_units"]
    pool = make_pool(tr, cell.config["overrides"], seed, device)
    out: dict = {"workload": cell.name, "seed": seed}
    if tr["entry"] == "fit":
        from freesplat_tpu_torch.training.trainer import TrainCfg, fit, init_state

        cfg = common.port_config(cell)
        train_cfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss,
                             optimizer=cfg.optimizer, log_every=tr["log_every"])
        enc_sd, lp_sd = common.draw_weights(cell, seed, device)
        state = init_state(train_cfg, seed=cfg.seed, device=device)
        state["encoder"].load_state_dict(enc_sd, strict=True)
        lpips = common.port_lpips(lp_sd, device)
        del enc_sd, lp_sd
        root, first = "step", [0]

        def call(warm, n, on_start=None, wrap=iter):
            nonlocal state
            feed = common.Feed(pool, first[0], warm, None, device, limit=n, on_start=on_start)
            state = fit(train_cfg, state, wrap(feed), 10**12, lpips=lpips,
                        log_fn=lambda s, v: None)
            first[0] = feed.units[-1] + 1
            return feed
    else:
        from freesplat_tpu_torch.evaluation.harness import run_test

        cfg = common.port_config(cell, (f"test.output_path={out_dir}",))
        enc_sd, lp_sd = common.draw_weights(cell, seed, device)
        lpips = common.port_lpips(lp_sd, device)
        root, first = "scene", [0]

        def call(warm, n, on_start=None, wrap=iter):
            feed = common.Feed(pool, first[0], warm, None, device, limit=n, on_start=on_start,
                               name=lambda item, k: {**item, "scene": [f"u{k:04d}"]})
            run_test(cfg, batches=wrap(feed), state=enc_sd, lpips=lpips, device=device)
            first[0] = feed.units[-1] + 1
            return feed

    session: list[Session] = []

    def start_plain(k):
        session.append(Session())
        session[0].begin()

    feed = call(tr["warmup_units"], units, start_plain)
    session = session[0]
    session.end()
    out["plain_unit_ms"] = 1e3 * session.host_s[0] / feed.handed

    rec = Recorder()
    with recording(rec):
        feed = call(0, units, lambda k: session.begin(rec))
        session.end()
    out["recorded_unit_ms"] = 1e3 * session.host_s[1] / feed.handed
    probes = [probe(session, device) for _ in range(3 if probe_too else 0)]
    if probe_too:
        out["span_cost_us"] = {"recorder, profiler on": span_cost(True)}
    session.close()
    if probe_too:
        out["span_cost_us"].update({"no recorder": span_cost(False),
                                    "recorder": span_cost(True)})
    tree = rec.flush()
    red, lo, hi = session.reduce(1, tree)
    out["busy_share"] = {"plain": session.busy_share(0), "recorded": session.busy_share(1)}
    out["metrics"] = spans.metrics(tr["entry"], tree, red, lo, hi)
    out["idle_by_span"] = red["idle_by_span"]
    out["by_path"] = {p: {k: (round(v, 6) if isinstance(v, float) else v) for k, v in d.items()}
                      for p, d in red["by_path"].items()}
    out["counters"] = counters_by_unit(tree)
    out["annotations"] = collections.Counter(a[1] for a in session.annotations)
    if probes:
        out["probe"] = [probe_result(session, 2 + i, *p) for i, p in enumerate(probes)]
        out["probe_annotations"] = [a for a in session.annotations if a[0] == "probe.sleep"]

    if torch.cuda.is_available():  # units without a recorder and with, in turns
        out["sync_census"] = []
        for on in (False, True, False, True):
            rec = Recorder() if on else None
            with recording(rec):
                census = sync_census(lambda wrap: call(0, 1, wrap=wrap))
            if on:
                unit = next(s.unit for s in rec.spans if s.name == root)
                census["host_syncs"] = counters_by_unit(rec.flush())[str(unit)]
            out["sync_census"].append({"recording": on, **census})
    out["root"] = root
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--probe", action="store_true")
    args = p.parse_args(argv)
    harness.set_environment()
    cell = harness.load_cell(args.workload)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("span_stretch: needs a CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="perfbench-spans-") as tmp:
        out = run(cell, args.seed, "cuda", Path(tmp), args.probe)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
