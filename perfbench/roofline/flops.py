"""Model FLOPs of one unit of work (a train step or a scene), counted by
``torch.utils.flop_counter.FlopCounterMode`` around the frozen reference's
own step: its convolutions, matrix products and their backward at the
cell's shapes.  Elementwise work, the compositor included, is not counted
(the rasterizer has its own roofline), and the program's recomputation
(the whole-scene backbone runs twice a chunk) is not either."""
from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def counter() -> FlopCounterMode:
    return FlopCounterMode(display=False)


def total(mode: FlopCounterMode) -> float:
    return float(mode.get_total_flops())
