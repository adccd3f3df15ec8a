"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by
``nvcc`` into ``build/kernels/lib<name>-<hash>.so`` at the repository root
(the hash covers the source, every ``csrc/*.cuh`` header and the flags, so
an edited source or header rebuilds).
No PyTorch headers are included: a build takes seconds, not minutes.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so every multiply
and add rounds on its own as PyTorch's elementwise ops do; no fast math,
because parity with the plain versions needs IEEE ``expf``/``log1pf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when cached), "log": ptxas output}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, csrc: Path = CSRC) -> Path:
    """Compile ``<csrc>/<name>.cu`` unless an up-to-date library exists.
    ``csrc`` other than the package's own (another tree's sources, to time
    against) records its build under ``<dir name>/<name>``."""
    out = library_path(name, csrc)
    key = name if csrc == CSRC else f"{csrc.name}/{name}"
    if out.exists():
        BUILD_INFO.setdefault(key, {"seconds": 0.0, "log": "cached"})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_INFO[key] = {
        "seconds": time.perf_counter() - t0,
        "log": (proc.stdout + proc.stderr).strip(),
    }
    return out


def build_all(names: list[str]) -> dict[str, Path]:
    """Build several kernels at once: one ``nvcc`` process per source."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load_library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
