"""Gaussian .ply export (reference ``src/model/ply_export.py:26-92``).

A copy of ``freesplat_tpu/utils/ply_export.py``: the test harness hands it
host (numpy) copies of the encoder's outputs.  Writes the standard 3DGS
ply layout (x, y, z, nx, ny, nz, f_dc_*, opacity as logit, scale_* as
log, rot_*) with the reference's Polycam-style axis shuffle.  Pure numpy
and a hand-rolled binary little-endian PLY writer (no ``plyfile``).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _inverse_sigmoid(x: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    x = np.clip(x, eps, 1 - eps)
    return np.log(x / (1 - x))


def export_ply(
    means: np.ndarray,  # (g, 3)
    scales: np.ndarray,  # (g, 3)
    rotations: np.ndarray,  # (g, 4) xyzw
    harmonics: np.ndarray,  # (g, 3, d_sh)
    opacities: np.ndarray,  # (g,)
    path: str | Path,
    mask: np.ndarray | None = None,  # (g,) bool — drop invalid slots
) -> None:
    if mask is not None:
        means = means[mask]
        scales = scales[mask]
        rotations = rotations[mask]
        harmonics = harmonics[mask]
        opacities = opacities[mask]
    g = means.shape[0]

    # Polycam-style axis shuffle (reference ply_export.py:38-44): the
    # reference applies a rotation that flips to the viewer's convention.
    shuffle = np.array(
        [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32
    )
    means = means @ shuffle.T

    f_dc = harmonics[:, :, 0]  # DC-only SH (reference exports only DC)
    fields = {
        "x": means[:, 0],
        "y": means[:, 1],
        "z": means[:, 2],
        "nx": np.zeros(g, np.float32),
        "ny": np.zeros(g, np.float32),
        "nz": np.zeros(g, np.float32),
        "f_dc_0": f_dc[:, 0],
        "f_dc_1": f_dc[:, 1],
        "f_dc_2": f_dc[:, 2],
        "opacity": _inverse_sigmoid(opacities),
        "scale_0": np.log(np.maximum(scales[:, 0], 1e-8)),
        "scale_1": np.log(np.maximum(scales[:, 1], 1e-8)),
        "scale_2": np.log(np.maximum(scales[:, 2], 1e-8)),
        # wxyz order in the 3DGS ply convention.
        "rot_0": rotations[:, 3],
        "rot_1": rotations[:, 0],
        "rot_2": rotations[:, 1],
        "rot_3": rotations[:, 2],
    }

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {g}"]
    header += [f"property float {name}" for name in fields]
    header += ["end_header"]
    data = np.stack(
        [np.asarray(v, np.float32) for v in fields.values()], axis=-1
    ).astype("<f4")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def load_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Minimal reader for round-trip tests of our own exporter."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        count = next(
            int(h.split()[-1]) for h in header if h.startswith("element vertex")
        )
        names = [h.split()[-1] for h in header if h.startswith("property")]
        raw = np.frombuffer(f.read(), dtype="<f4").reshape(count, len(names))
    return {n: raw[:, i].copy() for i, n in enumerate(names)}
