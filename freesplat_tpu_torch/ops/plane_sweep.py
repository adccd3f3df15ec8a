"""The plane sweep and its MLP head in one kernel, for serving.

``plane_sweep`` launches ``csrc/plane_sweep.cu``: the ``avg_mlp`` cost
volume of ``models/cost_volume.py::CostVolume`` from the current and
source features, the plane depths, the pixel rays and the projections,
writing only the (B, h, w, D) volume.  ``CostVolume`` calls it where no
gradient can flow, on CUDA float32 tensors, with a float32 head of the
widths the kernel was built for (``kernel_takes``).  Its plane-chunk loop
is the plain version: the path of the CPU, of autograd and of every other
case, and the kernel's judge on the card (``chip_smoke.py``'s
``[plane_sweep]``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn

# Kernel launches since the last reset (one per launch).
launch_count = {"plane_sweep": 0}

CHANNELS = (48,)  # the feature widths the kernel is built for: every preset's matching_dim
HIDDEN = (32, 32, 1)  # the head's widths
MAX_SOURCES = 16


def head_widths(mlp: nn.Module) -> tuple[int, ...] | None:
    """(input, *outputs) of an ``MLP`` without a final activation whose
    layers compute in float32 with float32 parameters; None otherwise."""
    layers = [getattr(mlp, f"dense_{i}") for i in range(mlp.n)]
    if not mlp.disable_final_activation or any(
            m.compute_dtype not in (None, torch.float32) or m.bias is None
            or m.weight.dtype != torch.float32 or m.bias.dtype != torch.float32
            for m in layers):
        return None
    return (layers[0].in_features, *(m.out_features for m in layers))


def pack_head(mlp: nn.Module) -> torch.Tensor:
    """The head's weights in the kernel's layout: W1^T (c + 1, 32), b1,
    W2^T (32, 32), b2, w3 (32), b3, flat float32."""
    d0, d1, d2 = mlp.dense_0, mlp.dense_1, mlp.dense_2
    return torch.cat([d0.weight.t().reshape(-1), d0.bias, d1.weight.t().reshape(-1), d1.bias,
                      d2.weight.reshape(-1), d2.bias]).detach().contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The C entry point of csrc/plane_sweep.cu (built at first use)."""
    from ..utils.cuda_build import load_library

    fn = load_library("plane_sweep").freesplat_plane_sweep
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # cur, src, depths, rays, proj, head, B, S, H, W, C, D, out, stream
    fn.restype, fn.argtypes = i32, [ptr] * 6 + [i32] * 6 + [ptr, ptr]
    return fn


def plane_sweep(cur: torch.Tensor, src: torch.Tensor, depths: torch.Tensor,
                rays: torch.Tensor, proj: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(B, h, w, D) float32 cost volume from cur (B, h, w, c), src (B, s, h,
    w, c), depths (B, D), rays (B, h * w, 3), proj (B, s, 3, 4) and the
    packed head (``pack_head``), all float32 on one CUDA device.  Launches
    the kernel once (and counts the launch)."""
    b, h, w, c = cur.shape
    s, d = src.shape[1], depths.shape[1]
    if cur.device.type != "cuda":
        raise RuntimeError(f"plane_sweep: a CUDA kernel, got tensors on {cur.device}")
    if c not in CHANNELS or not 1 <= s <= MAX_SOURCES:
        raise ValueError(f"plane_sweep: c in {CHANNELS} and 1 to {MAX_SOURCES} sources, "
                         f"got c = {c}, {s} sources")
    k = c + 1
    args = []
    for name, x, shape in (("cur", cur, (b, h, w, c)), ("src", src, (b, s, h, w, c)),
                           ("depths", depths, (b, d)), ("rays", rays, (b, h * w, 3)),
                           ("proj", proj, (b, s, 3, 4)),
                           ("head", head, (k * 32 + 32 + 32 * 32 + 32 + 32 + 1,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != cur.device:
            raise ValueError(f"plane_sweep: {name} must be float32 of shape {shape} on "
                             f"{cur.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        x = x.contiguous()
        args.append(x.clone() if x.data_ptr() % 16 else x)  # the kernel's float4 loads
    out = torch.empty((b, h, w, d), dtype=torch.float32, device=cur.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(cur.device):
        rc = _kernel_entry()(*(x.data_ptr() for x in args), b, s, h, w, c, d, out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"plane_sweep launch failed: cudaError {rc}")
    launch_count["plane_sweep"] += 1
    return out
