"""Multi-device setup: one process a device, in a ``torch.distributed``
process group.

Port of ``freesplat_tpu/parallel/distributed.py``.  JAX drives every
device of a host from one process through a ``Mesh``, and XLA's
partitioner inserts the collectives; here each device has its own
process (``torchrun --nproc_per_node N``), and the collectives are
explicit calls: ``all_reduce`` (SUM or MIN), ``all_gather`` and, as the
gather's backward, a reduce-scatter.  NCCL on CUDA devices, gloo when the
caller asks for the CPU (the tests).

- ``maybe_initialize_distributed``: the process group from the launch's
  variables (JAX's coordinator variables, or torchrun's).
- ``make_group``: the counterpart of ``make_mesh``, checked against
  ``trainer.devices``.
- ``local_batch`` (``shard_batch`` for a caller holding a global
  batch), ``replicate_state``, ``pad_views``.
- The autograd-aware collectives the sharded paths use.

The ``test.view_shard`` encode (JAX's ``make_view_sharded_encode``) is
``evaluation/harness.py::make_chunked_encode`` with a group.
"""
from __future__ import annotations

import os
from typing import Any, Mapping

import torch
import torch.distributed as dist

# Only launch variables imply a multi-process run: a single process with
# none of them takes no group.
_COORDINATOR_VARS = (
    ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"),
    ("NUM_PROCESSES", "JAX_NUM_PROCESSES"),
    ("PROCESS_ID", "JAX_PROCESS_ID"),
)
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _env(*names: str) -> str | None:
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def _backend(device: str | torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> bool:
    """Initialize the default process group when the process was launched
    as one rank of several; no-op (False) for a single-process run.  True
    when a group is (or already was) initialized.

    The launch spec, in this order:
    - ``FREESPLAT_DISTRIBUTED=0`` forbids a group, ``=1`` requires one;
    - ``COORDINATOR_ADDRESS`` (host:port), ``NUM_PROCESSES`` and
      ``PROCESS_ID``, or their ``JAX_`` forms: ``init_method="tcp://..."``;
    - torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
      ``MASTER_PORT``: ``init_method="env://"``.
    A partial set of either raises: N processes training alone on equal
    seeds is the worst failure, silent and plausible-looking.  The backend
    is NCCL for a CUDA ``device`` (each rank on ``cuda:LOCAL_RANK``,
    ``rank_device``) and gloo for the CPU."""
    if dist.is_initialized():
        return True
    force = os.environ.get("FREESPLAT_DISTRIBUTED")
    if force == "0":
        return False
    coord = [_env(*names) for names in _COORDINATOR_VARS]
    run = [os.environ.get(name) for name in _TORCHRUN_VARS]
    backend = _backend(device)
    if any(coord):
        if not all(coord):
            missing = [names[0] for names, v in zip(_COORDINATOR_VARS, coord) if not v]
            raise RuntimeError(
                f"incomplete multi-process launch spec: missing {missing} (set all of "
                "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID, or launch with torchrun)")
        addr, nproc, pid = coord
        kwargs = dict(init_method=f"tcp://{addr}", world_size=int(nproc), rank=int(pid))
        os.environ.setdefault("LOCAL_RANK", str(int(pid) % max(_local_devices(device), 1)))
    elif any(run):
        if not all(run):
            missing = [n for n, v in zip(_TORCHRUN_VARS, run) if not v]
            raise RuntimeError(f"incomplete torchrun launch spec: missing {missing}")
        kwargs = dict(init_method="env://")
    elif force == "1":
        raise RuntimeError("FREESPLAT_DISTRIBUTED=1 but no launch spec (COORDINATOR_ADDRESS/"
                           "NUM_PROCESSES/PROCESS_ID or torchrun's RANK/WORLD_SIZE/MASTER_*)")
    else:
        return False
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend=backend, **kwargs)
    return True


def _local_devices(device: str | torch.device) -> int:
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a CUDA ``device`` with no
    index under a launcher (``LOCAL_RANK`` set), else ``device``."""
    device = torch.device(device)
    local = os.environ.get("LOCAL_RANK")
    if device.type == "cuda" and device.index is None and local is not None:
        return torch.device("cuda", int(local))
    return device


def process_rank() -> tuple[int, int]:
    """(rank, world size) of ``torch.distributed`` when it is initialized,
    else (0, 1): each process streams a disjoint share of the data."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_group(num_devices: int | str = "auto"):
    """The process group for ``trainer.devices``: the default group when
    one is initialized (also at world size 1), else None (one process, no
    collectives).  ``"auto"`` takes the world size; an integer must equal
    it: ``data_loader.batch_size`` is per process, so no group is shrunk
    to fit a batch (JAX's single-process rule) and a mismatch raises."""
    world = process_rank()[1]
    if num_devices != "auto" and int(num_devices) != world:
        raise ValueError(
            f"trainer.devices={num_devices} but the world size is {world}: launch one process "
            f"a device (torchrun --nproc_per_node {num_devices}) or set trainer.devices=auto")
    return dist.group.WORLD if dist.is_initialized() else None


def group_rank(group) -> tuple[int, int]:
    """(rank, size) of this process in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_batch(batch: Any, rank: int, world: int) -> Any:
    """This rank's share of a global batch: every array's and list's
    leading (batch) axis split in ``world`` equal parts, part ``rank``
    kept; the counterpart of JAX's ``shard_batch`` for a caller that holds
    the global batch (a launch feeds each process its own batch)."""
    if isinstance(batch, Mapping):
        return {k: local_batch(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)) or getattr(batch, "ndim", 0) >= 1:
        b = len(batch)
        if b % world:
            raise ValueError(f"global batch {b} does not split over {world} ranks")
        return batch[rank * (b // world):(rank + 1) * (b // world)]
    return batch


@torch.no_grad()
def replicate_state(state: dict, group) -> dict:
    """Broadcast from rank 0 the encoder's parameters and buffers and the
    optimizer's state tensors (every rank must already hold the same
    structure: a same-seed init or the same checkpoint)."""
    if group is None:
        return state
    src = dist.get_global_rank(group, 0)
    tensors = [*state["encoder"].parameters(), *state["encoder"].buffers()]
    opt = state.get("optimizer")
    if opt is not None:
        for p in state["encoder"].parameters():
            tensors += [v for _, v in sorted(opt.state.get(p, {}).items())
                        if torch.is_tensor(v)]
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)
    return state


def pad_views(context: dict, multiple: int) -> tuple[dict, int]:
    """Pad the view axis (dim 1) up to a multiple by repeating the last
    view; returns (padded context, original view count).  Extra views
    only add duplicate Gaussians (PTF merges them) — callers slice
    per-view outputs back to ``v`` where it matters."""
    v = context["image"].shape[1]
    pad = (-v) % multiple
    if pad == 0:
        return context, v

    def pad_arr(x):
        if torch.is_tensor(x) and x.dim() >= 2 and x.shape[1] == v:
            return torch.cat([x, *[x[:, -1:]] * pad], dim=1)
        return x

    return {k: pad_arr(x) for k, x in context.items()}, v


# ---------------------------------------------------------------------------
# Collectives.  Each takes ``group=None`` as one process (no call).


def _gather_list(x: torch.Tensor, group) -> list[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum ``x`` over the ranks and keep this rank's equal slice along
    ``dim``: NCCL's ``reduce_scatter_tensor``; gloo has none, so there it
    is an ``all_reduce`` and a slice."""
    rank, world = group_rank(group)
    if dist.get_backend(group) == "nccl":
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // world, *moved.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, moved, group=group)
        return out.movedim(0, dim)
    total = x.contiguous().clone()
    dist.all_reduce(total, group=group)
    return total.chunk(world, dim)[rank]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(_gather_list(x, group), dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(_gather_list(x, group), dim)

    @staticmethod
    def backward(ctx, grad):
        rank, world = group_rank(ctx.group)
        return grad.chunk(world, ctx.dim)[rank].contiguous(), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank
    order.  The backward is JAX's transpose of ``all_gather``, a
    reduce-scatter: each rank's partial gradients of the whole are summed
    and each rank keeps its own part (for a gathered input that every rank
    uses to compute a part of the result, as the sharded render's screen
    parameters)."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_gather_cat`` for a result that every rank then uses alike (a
    replicated output, such as the sharded render's image): every rank's
    loss of it is the same, so the gradient of its part is its own slice of
    the gradient, with no communication."""
    if group is None:
        return x
    return _GatherReplicated.apply(x, group, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks; differentiable (the gradient is summed
    over the ranks too: every rank's loss depends on every rank's ``x``)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks for a result that every rank then uses
    alike (the sharded PTF's winning rows): the gradient of each rank's
    ``x`` is the result's, with no communication."""
    if group is None:
        return x
    return _SumReplicated.apply(x, group)


def all_reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    """Element-wise minimum of ``x`` over the ranks (no gradient)."""
    if group is None:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out


def all_gather_plain(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_gather_cat`` without a gradient (integer and bool tensors
    too)."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        return all_gather_plain(x.to(torch.uint8), group, dim).bool()
    return torch.cat(_gather_list(x.detach(), group), dim)
