"""Checkpoint save/restore of the training state.

Port of ``freesplat_tpu/training/checkpoint.py`` in the port's own format
(``torch.save``; the JAX package's orbax checkpoints are not read).
``<dir>/step_<n>/state.pt`` holds the encoder's ``state_dict`` (parameters
and BN running buffers), the Adam ``state_dict`` and the step.

``strict=False`` restores partially, as the JAX package does: tensors
whose name, shape and dtype match are grafted onto the fresh state, the
others keep their fresh values, and the optimizer stays fresh (a changed
parameter set invalidates its moments).
"""
from __future__ import annotations

import os

import torch

_FILE = "state.pt"


def save_checkpoint(directory: str, step: int, state: dict) -> None:
    """Write ``state`` (encoder, optimizer, step) to ``<directory>/step_<step>/``,
    replacing an earlier checkpoint of that step."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{_FILE}.{os.getpid()}.tmp")
    torch.save(
        {
            "encoder": state["encoder"].state_dict(),
            "optimizer": state["optimizer"].state_dict(),
            "step": int(state["step"]),
        },
        tmp,
    )
    os.replace(tmp, os.path.join(path, _FILE))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, device: str | torch.device = "cpu") -> dict:
    """The saved ``{"encoder", "optimizer", "step"}`` with tensors on ``device``."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}", _FILE)
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(directory: str, step: int, state: dict, strict: bool = True) -> dict:
    """Restore the checkpoint of ``step`` into ``state``'s encoder and
    optimizer in place and return the state with the saved step.  With
    ``strict=False`` graft only matching tensors and keep the fresh
    optimizer."""
    encoder, optimizer = state["encoder"], state["optimizer"]
    device = next(encoder.parameters()).device
    saved = load_checkpoint(directory, step, device)
    if strict:
        encoder.load_state_dict(saved["encoder"], strict=True)
        optimizer.load_state_dict(saved["optimizer"])
        return {**state, "step": int(saved["step"])}
    own = encoder.state_dict()
    graft = {
        k: v for k, v in saved["encoder"].items()
        if k in own and v.shape == own[k].shape and v.dtype == own[k].dtype
    }
    encoder.load_state_dict(graft, strict=False)
    return {**state, "step": int(saved["step"])}
