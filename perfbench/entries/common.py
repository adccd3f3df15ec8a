"""What both entries share: the port's configuration from a configuration
file, the weights drawn from the seed, the reference's modules, the feed
that hands out warm-up units and then the window's, and the comparisons'
arithmetic."""
from __future__ import annotations

import statistics
import time

import torch

from ..harness import Cell
from ..reference.lpips import LPIPS
from ..reference.model import Encoder, EncoderSizes
from ..weights import draw, make_generator, shapes_of


def _text(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (list, tuple)):
        return "[" + ",".join(_text(v) for v in value) + "]"
    return str(value)


def port_config(cell: Cell, extra: tuple[str, ...] = ()):
    """The port's ``RootCfg``: the preset, then the file's overrides."""
    from freesplat_tpu_torch.config.config import load_config

    args = [f"+experiment={cell.config['preset']}"]
    args += [f"{k}={_text(v)}" for k, v in cell.config["overrides"].items()]
    return load_config(args + list(extra))


def reference_modules(cell: Cell) -> tuple[Encoder, LPIPS]:
    """The reference's encoder and LPIPS on the meta device (shapes only)."""
    with torch.device("meta"):
        return Encoder(EncoderSizes.from_overrides(cell.config["overrides"])), LPIPS()


def draw_weights(cell: Cell, seed: int, device) -> tuple[dict, dict]:
    """(encoder state dict, LPIPS state dict) drawn on ``device`` from ``seed``."""
    enc, lp = reference_modules(cell)
    g = make_generator(seed, torch.device(device))
    return draw(shapes_of(enc), g, device), draw(shapes_of(lp), g, device)


def load_reference(cell: Cell, enc_sd: dict, lp_sd: dict, device) -> tuple[Encoder, LPIPS]:
    enc, lp = reference_modules(cell)
    enc.load_state_dict({k: v.to(device) for k, v in enc_sd.items()}, assign=True)
    lp.load_state_dict({k: v.to(device) for k, v in lp_sd.items()}, assign=True)
    return enc, lp.requires_grad_(False)


def port_lpips(lp_sd: dict, device):
    """The port's LPIPS module holding the drawn weights, frozen."""
    from freesplat_tpu_torch.training.lpips import LPIPS as PortLPIPS

    with torch.device(device):
        module = PortLPIPS()
    module.load_state_dict(lp_sd, strict=True)
    return module.requires_grad_(False).eval()


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if _cuda(device):
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated()) if _cuda(device) else 0


def reset_peak(device) -> None:
    if _cuda(device):
        torch.cuda.reset_peak_memory_stats()


def free(device) -> None:
    if _cuda(device):
        torch.cuda.empty_cache()


class Feed:
    """Hands out ``warm`` units, then synchronizes, calls ``on_start`` and
    stamps the window's start, then hands out units until ``seconds``
    have passed or ``limit`` units have gone (at least one).  Unit k is
    pool item k modulo the pool's size, passed through ``name(item, k)``."""

    def __init__(self, pool, first: int, warm: int, seconds: float | None, device,
                 limit: int | None = None, on_start=None, on_unit=None, name=None):
        self.pool, self.first, self.warm, self.seconds, self.limit = pool, first, warm, seconds, limit
        self.device, self.on_start, self.on_unit = device, on_start, on_unit
        self.name = name or (lambda item, k: item)
        self.start = None
        self.handed = 0  # window units
        self.units: list[int] = []  # unit index of each window unit
        self.stamps: list[float] = []  # host clock as each window unit is handed out

    def __iter__(self):
        k = self.first
        for _ in range(self.warm):
            if self.on_unit is not None:
                self.on_unit(k)
            yield self.name(self.pool[k % len(self.pool)], k)
            k += 1
        sync(self.device)
        if self.on_start is not None:
            self.on_start(k)
        self.start = time.perf_counter()
        self.host = HostClock()
        while self.handed == 0 or (
                (self.seconds is None or time.perf_counter() - self.start < self.seconds)
                and (self.limit is None or self.handed < self.limit)):
            if self.on_unit is not None:
                self.on_unit(k)
            self.units.append(k)
            self.stamps.append(time.perf_counter())
            self.handed += 1
            yield self.name(self.pool[k % len(self.pool)], k)
            k += 1


class HostClock:
    """This process's CPU time over the window against the window's length:
    near 1, the host thread never waits on the device, and the window's
    length follows the host's speed."""

    def __init__(self):
        self.cpu, self.wall = time.process_time(), time.perf_counter()

    def note(self) -> str:
        return (f"host: process CPU {time.process_time() - self.cpu:.2f} s of "
                f"{time.perf_counter() - self.wall:.2f} s")


def unit_note(feed: Feed, t_end: float) -> str:
    """The host's CPU time over the window, and the window's units in ms,
    from the host clock at each hand-out."""
    edges = feed.stamps + [t_end]
    return (feed.host.note() + "; unit ms: "
            + " ".join(f"{1000 * (b - a):.1f}" for a, b in zip(edges, edges[1:])))


def worst_relative(prog: dict, ref: dict, keys=None) -> float:
    """max over ``keys`` of |prog - ref| / max(|ref|, median |ref|)."""
    keys = list(ref) if keys is None else list(keys)
    if not keys:
        return float("nan")
    med = statistics.median(abs(ref[k]) for k in keys)
    return max(abs(prog[k] - ref[k]) / max(abs(ref[k]), med, 1e-30) for k in keys)
