"""Row gather whose gradient sums in a fixed order.

``x.index_select(0, index)`` has ``index_add_`` as its backward, which on
the GPU adds the rows of repeated indices with float atomics, in whatever
order the threads arrive: two train steps from one seed then differ in the
last bits, and the losses of later steps drift apart.  The JAX package's
gathers (XLA scatter-adds) are deterministic on the TPU and on the CPU.

``take_rows`` is the port's gather where a gradient flows: its forward is
``index_select``; its backward takes a stable sort of the index once,
the segment offsets of each source row, and sums each row's
contributions in sorted order (``segment_sum``: the hand-written kernel
``csrc/segment_sum.cu`` on CUDA tensors, ``segment_sum_plain``, the same
additions in the same order, on CPU tensors).  The plain version is also
the kernel's judge on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# Kernel launches by wrapper since the last reset (one per launch).
launch_count = {"segment_sum": 0}


def segment_plan(index: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets) of a gather index: ``order`` (n,) int64 is a stable
    sort of ``index`` (equal indices keep their order), and the entries
    of row r are ``order[offsets[r]:offsets[r + 1]]``, offsets (rows + 1,)
    int64."""
    # 32-bit keys where they fit: half the radix passes of 64-bit ones.
    dtype = torch.int32 if rows < 2**31 - 1 else torch.int64
    keys, order = torch.sort(index.to(dtype), stable=True)
    bounds = torch.arange(rows + 1, device=index.device, dtype=dtype)
    return order, torch.searchsorted(keys, bounds)


def segment_sum_plain(src: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                      rows: int) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/segment_sum.cu``: (rows, cols),
    ``out[r] = sum of src[order[k]]`` over k in ``[offsets[r],
    offsets[r + 1])``, added in increasing k.  Step j adds the j-th entry
    of every row that has one."""
    counts = offsets[1:] - offsets[:-1]
    out = src.new_zeros((rows, src.shape[1]))
    longest = int(counts.max()) if rows else 0
    by_len = torch.argsort(counts, descending=True, stable=True)
    # more[j]: the rows with more than j entries, the first of ``by_len``.
    more = (rows - torch.cumsum(torch.bincount(counts, minlength=longest + 1), 0)).tolist()
    for j in range(longest):
        r = by_len[: more[j]]
        out[r] = out[r] + src[order[offsets[r] + j]]
    return out


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The C entry point of csrc/segment_sum.cu (built at first use)."""
    from ..utils.cuda_build import load_library

    fn = load_library("segment_sum").freesplat_segment_sum
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # src, order, offsets, rows, cols, out, stream
    fn.restype, fn.argtypes = i32, [ptr, ptr, ptr, i32, i32, ptr, ptr]
    return fn


def segment_sum(src: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                rows: int) -> torch.Tensor:
    """(rows, cols) segment sums of ``src`` (n, cols) float32: CUDA tensors
    launch the ``segment_sum`` kernel (and count the launch), CPU tensors
    take ``segment_sum_plain``."""
    if src.device.type == "cpu":
        return segment_sum_plain(src, order, offsets, rows)
    if src.device.type != "cuda":
        raise RuntimeError(f"segment_sum: unsupported device {src.device}")
    n, cols = src.shape
    for name, x, dtype, shape in (("src", src, torch.float32, (n, cols)),
                                  ("order", order, torch.int64, (n,)),
                                  ("offsets", offsets, torch.int64, (rows + 1,))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != src.device:
            raise ValueError(f"segment_sum: {name} must be contiguous {dtype} of shape {shape} "
                             f"on {src.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if cols > 128 or rows >= 2**31:
        raise ValueError(f"segment_sum: at most 128 columns and 2^31 rows, got ({rows}, {cols})")
    out = torch.empty((rows, cols), dtype=torch.float32, device=src.device)
    if rows == 0 or cols == 0:
        return out
    with torch.cuda.device(src.device):
        rc = _kernel_entry()(src.data_ptr(), order.data_ptr(), offsets.data_ptr(), rows, cols,
                             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {rc}")
    launch_count["segment_sum"] += 1
    return out


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        rows = ctx.shape[0]
        order, offsets = segment_plan(index, rows)
        cols = ctx.shape[1:].numel()
        src = grad.reshape(index.shape[0], cols).float().contiguous()
        dx = segment_sum(src, order, offsets, rows)
        return dx.reshape(ctx.shape).to(ctx.dtype), None


def take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x.index_select(0, index)`` (index 1-D), whose gradient in ``x``
    sums the rows of repeated indices in the index's order, the same on
    every run (``segment_sum``)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.index_select(0, index)
    return _TakeRows.apply(x, index)
