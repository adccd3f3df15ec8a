"""Rasterizer smoke script: render an analytic Gaussian on a spin path.

Port of ``freesplat_tpu/scripts/test_splatter.py`` (parity target
``src/scripts/test_splatter.py:21-101``): the reference's manual golden
test for projection + SH conventions — one anisotropic Gaussian with
known SH coefficients rendered along an orbit by the plain compositor
(``ops/rasterizer_ref.py``), frames written to disk for visual inspection.

Run (the GPU unless ``--device cpu``):
  python -m freesplat_tpu_torch.scripts.test_splatter [out_dir] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..models.types import Gaussians
from ..ops.gaussians import build_covariance
from ..ops.rasterizer_ref import render_reference
from ..utils.camera_trajectory import generate_spin
from ..utils.device import resolve_device
from ..utils.visualization import save_video


@torch.no_grad()
def main(out_dir: str = "outputs/test_splatter", num_frames: int = 24,
         device: str | torch.device = "cuda") -> list[np.ndarray]:
    """Render and write ``num_frames`` PNGs and ``spin.gif`` into
    ``out_dir``; returns the frames (h, w, 3) in [0, 1]."""
    device = resolve_device(device)
    # One anisotropic Gaussian at the origin with a strong degree-1 SH
    # (view-dependent color): the reference's analytic probe.
    means = torch.zeros((1, 3), device=device)
    cov = build_covariance(
        torch.tensor([[0.8, 0.3, 0.3]], device=device),
        torch.tensor([[0.0, 0.0, 0.38268343, 0.92387953]], device=device),  # 45 deg about z
    )
    d_sh = 4
    harmonics = torch.zeros((1, 3, d_sh), device=device)
    harmonics[0, 0, 0] = 1.0  # red DC
    harmonics[0, 1, 3] = 1.5  # green varies with -x dir
    harmonics[0, 2, 1] = 1.5  # blue varies with -y dir
    opac = torch.tensor([0.9], device=device)
    g = Gaussians(means, cov, harmonics, opac)

    intr = torch.tensor([[1.2, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], device=device)
    traj = torch.as_tensor(generate_spin(num_frames, elevation_deg=15.0, radius=4.0),
                           device=device)

    frames = []
    for extr in traj:
        color, _, _ = render_reference(
            g.means, g.covariances, g.harmonics, g.opacities,
            extr, intr, (128, 128), torch.zeros(3, device=device), 1,
        )
        frames.append(torch.clamp(color, 0, 1).cpu().numpy())

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray((f * 255).astype(np.uint8)).save(out / f"{i:03}.png")
    save_video(frames, out / "spin.gif", fps=12)
    print(f"wrote {len(frames)} frames + spin.gif to {out}")
    return frames


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir", nargs="?", default="outputs/test_splatter")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.out_dir, device=a.device)
