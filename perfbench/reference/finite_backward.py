"""The reference encoder with a finite backward at extreme activations.

At 8 contexts a step holds 1.5 M Gaussians, and on some seeds' scenes the
encoder's logits pass -88 within the first steps.  Two places of the
frozen ``model.py`` then give a NaN backward from a finite loss, and with
it every gradient NaN.  The port guards both (``freesplat_tpu_torch/
models/adapter.py`` clamps its scale logits at -80; ``models/ptf.py``
raises the densities its averages weigh by 1e-18 under autograd), and so
does this reference:

- The scale logits x go through 1 / (1 + exp(-x)).  Where exp(-x)
  overflows float32 (x < -88.7) the forward is 0 and the backward
  0 * inf.  FreeSplat computes sigmoid(x), whose backward there is 0.
  ``hold(encoder)`` clamps the scale logits at ``FLOOR`` as
  ``fuse.to_gaussians`` returns them: the scales are unchanged to the
  last bit (1 / (1 + exp(80)) = 1.8e-35 is far under the rounding of
  ``gaussian_scale_min``); below the floor the gradient is 0, where
  sigmoid's is under 1.8e-35.
- PTF's density-weighted averages divide by the sum of two densities,
  which are sigmoids: under -104 a density is 0 and the average 0 / 0, a
  NaN Gaussian that the renderer culls but whose gradient, 0 times NaN,
  is NaN; over a subnormal sum the division's backward overflows.
  ``fuse_views`` here is ``model.fuse_views`` but for one rule, the
  port's under autograd: each density is raised by ``DENSITY_FLOOR``
  where it weighs an average.  A density of 3e-11 or more keeps every
  bit (the floor is under half its rounding step); two lesser ones are
  weighed smoothly towards equal.
"""
from __future__ import annotations

import torch

from .model import _pack, _project, positional_encoding

SCALE_LOGITS = slice(2, 5)  # after opacity and its spare column
FLOOR = -80.0
DENSITY_FLOOR = 1e-18  # the average over a sum of two stays finite in the backward


def _clamp_scale_logits(module, args, out):
    head, scales, rest = (out[..., :SCALE_LOGITS.start], out[..., SCALE_LOGITS],
                          out[..., SCALE_LOGITS.stop:])
    return torch.cat([head, scales.clamp(min=FLOOR), rest], dim=-1)


def hold(encoder):
    """``encoder`` (a ``model.Encoder``) with its scale logits clamped at
    ``FLOOR``; returns it."""
    encoder.fuse.to_gaussians.register_forward_hook(_clamp_scale_logits)
    return encoder


def fuse_views(feats, coords, dens, wts, depths, extr, intr, image_shape, gru,
               depth_thres: float = 0.1, pe_freqs: int = 6):
    """``model.fuse_views``, with each density raised by ``DENSITY_FLOOR``
    where it weighs an average, under autograd."""
    v, hw, c = feats.shape
    dev = feats.device
    packed = _pack(feats[0], dens[0], wts[0], coords[0], depths[0],
                   extr[0].reshape(1, 16).expand(hw, 16))
    valid = torch.ones(hw, dtype=torch.bool, device=dev)
    for i in range(1, v):
        g = packed.shape[0]
        pix, z, ok = _project(packed[:, c + 2:c + 5], extr[i], intr[i], image_shape)
        ok = ok & valid
        slot = torch.arange(g, device=dev)
        target = torch.where(ok, pix, hw)  # hw: a bin no pixel reads
        zmin = torch.full((hw + 1,), torch.inf, device=dev).scatter_reduce(
            0, target, torch.where(ok, z, torch.inf), "amin")[:hw]
        win = ok & (z == zmin[torch.clamp(pix, 0, hw - 1)])
        winner = torch.full((hw + 1,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, torch.where(win, pix, hw), torch.where(win, slot, -1), "amax")[:hw]
        zbuf = torch.where(torch.isfinite(zmin), zmin, 1e4)
        fusion = (zbuf - depths[i]).abs() < torch.clamp(depths[i] * 0.05, min=depth_thres)
        matched = fusion & (winner >= 0)
        gathered = packed.index_select(0, torch.where(matched, winner, 0))
        g_feat, g_dens, g_wt = gathered[:, :c], gathered[:, c:c + 1], gathered[:, c + 1:c + 2]
        g_coords, g_depth = gathered[:, c + 2:c + 5], gathered[:, c + 5]
        g_extr = gathered[:, c + 6:c + 22].reshape(-1, 4, 4)
        in_emb = positional_encoding(torch.cat([g_dens, wts[i]], dim=-1), pe_freqs)
        hid_emb = positional_encoding(torch.cat([dens[i], g_wt], dim=-1), pe_freqs)
        fused_feat = gru(feats[i], g_feat, in_emb, hid_emb)
        w0, w1 = g_dens, dens[i]
        if torch.is_grad_enabled():
            w0, w1 = w0 + DENSITY_FLOOR, w1 + DENSITY_FLOOR
        denom = w0 + w1
        fused = _pack(
            fused_feat, g_dens + dens[i], g_wt + wts[i],
            (g_coords * w0 + coords[i] * w1) / denom,
            (g_depth * w0[:, 0] + depths[i] * w1[:, 0]) / denom[:, 0],
            ((g_extr * w0[..., None] + extr[i][None] * w1[..., None])
             / denom[..., None]).reshape(-1, 16))
        packed = packed.index_put((winner[matched],), fused[matched])
        own = _pack(feats[i], dens[i], wts[i], coords[i], depths[i],
                    extr[i].reshape(1, 16).expand(hw, 16))
        packed = torch.cat([packed, torch.where(~fusion[:, None], own, 0.0)])
        valid = torch.cat([valid, ~fusion])
    return packed, valid
