"""Process rank for host-side data code.

Port of ``freesplat_tpu/parallel/distributed.py::process_rank``; the rest
of that module (multi-device training) is not ported yet.
"""
from __future__ import annotations

import torch.distributed as dist


def process_rank() -> tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` when it is initialized,
    else (0, 1): each process streams a disjoint share of the data."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
