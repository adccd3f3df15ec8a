"""Weights drawn from the run's seed on the device, in a few large calls.

Every conv and dense kernel is lecun-normal by fan-in (a normal truncated
at two standard deviations, rescaled as flax's ``lecun_normal`` does),
every bias 0, BatchNorm scale 1 and shift 0, running mean 0 and variance
1.  The names and shapes come from the frozen reference's modules, built
on the meta device; the same state dict loads into the port.
"""
from __future__ import annotations

import torch

# flax's variance_scaling(truncated_normal): the std of N(0, 1) cut at +-2.
_TRUNC_STD = 0.87962566103423978


def draw(shapes: dict[str, torch.Size], generator: torch.Generator,
         device: torch.device) -> dict[str, torch.Tensor]:
    """State dict for ``shapes`` (name -> shape), kernels drawn in one call."""
    kernels = [(k, s) for k, s in shapes.items() if k.endswith("weight") and len(s) >= 2]
    numels = [s.numel() for _, s in kernels]
    flat = torch.empty(sum(numels), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator)
    fan_in = torch.tensor([float(s[1:].numel()) for _, s in kernels], device=device)
    flat *= torch.repeat_interleave(fan_in.rsqrt() / _TRUNC_STD,
                                    torch.tensor(numels, device=device))
    state = {k: t.view(s) for (k, s), t in zip(kernels, torch.split(flat, numels))}
    for k, s in shapes.items():
        if k in state:
            continue
        one = k.endswith("running_var") or (k.endswith("weight") and len(s) == 1)
        state[k] = (torch.ones if one else torch.zeros)(s, device=device)
    return state


def shapes_of(module: torch.nn.Module) -> dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()}


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g
