"""Flax variables (nested dicts of numpy arrays) -> the port's state_dict.

The port's modules keep the flax module names, so the mapping is
mechanical: ``params/backbone/stage0_block0/conv/kernel`` becomes
``backbone.stage0_block0.conv.weight``.  Layouts (the inverse of
``freesplat_tpu/utils/torch_convert.py``):

- conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw); depthwise
  (kh, kw, 1, C) -> (C, 1, kh, kw);
- dense kernel (I, O) -> weight (O, I);
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, and
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def jax_variables_to_torch(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map ``{"params": ..., "batch_stats": ...}`` onto state_dict keys."""
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(variables):
        coll, *mod, leaf = path
        if coll == "params":
            if leaf == "kernel" and arr.ndim == 4:
                name, arr = "weight", arr.transpose(3, 2, 0, 1)
            elif leaf == "kernel" and arr.ndim == 2:
                name, arr = "weight", arr.T
            elif leaf == "scale":
                name = "weight"
            elif leaf == "bias":
                name = "bias"
            else:
                raise KeyError(f"unmapped flax parameter {'/'.join(path)}")
        elif coll == "batch_stats" and leaf in _BN_STATS:
            name = _BN_STATS[leaf]
        else:
            raise KeyError(f"unmapped flax variable {'/'.join(path)}")
        key = ".".join([*mod, name])
        if key in sd:
            raise KeyError(f"two flax variables map onto {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return sd


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Strictly load flax ``variables`` into ``module``: every flax leaf is
    consumed and every parameter and buffer is filled with a tensor of its
    shape, or this raises with the names."""
    sd = jax_variables_to_torch(variables)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    bad_shape = sorted(
        f"{k}: flax {tuple(sd[k].shape)} vs torch {tuple(own[k].shape)}"
        for k in set(sd) & set(own) if sd[k].shape != own[k].shape
    )
    if missing or extra or bad_shape:
        raise ValueError(
            "flax variables do not match the module:\n"
            f"  torch keys with no flax variable: {missing}\n"
            f"  flax variables with no torch key: {extra}\n"
            f"  shape mismatches: {bad_shape}"
        )
    module.load_state_dict(sd, strict=True)
    return module
