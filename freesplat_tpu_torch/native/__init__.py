"""The threaded JPEG and depth-PNG decoder (C++), bound with ctypes.

Port of ``freesplat_tpu/native``: ``dataloader.cpp`` is the port's copy
of the JAX package's source, built with the same ``g++`` flags, so the
same host gives the same bits.  It decodes a batch of files on a thread
pool and resizes frames with Lanczos-3 and depth maps with PIL's bicubic
filter.

Built at first use into ``build/native/lib_dataloader-<hash>.so`` at the
repository root; the hash covers the source, the flags and what
``-march=native`` resolves to on this host, so an edited source rebuilds,
a build directory carried to another CPU builds that CPU's own library,
and no library is written into the package.  The first
call decides, once per process, whether the decoder is there:
``available()`` is False only when the build (or loading the library)
failed, with the reason in ``build_error()``; ``decoder_name()`` reads
back ``"native"`` or ``"pil"``.  A library that built and then fails on
a file raises ``RuntimeError``: callers do not fall back to PIL then
(the JAX loader does).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-ljpeg", "-lpng", "-pthread")

_lib: ctypes.CDLL | None = None
_error: str | None = None


def host_isa() -> str:
    """The target options ``-march=native`` enables on this host, as g++
    reports them (raises OSError when there is no g++)."""
    return subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True).stdout


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(host_isa().encode())
    return BUILD_DIR / f"lib_dataloader-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LINK_FLAGS],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (rc {proc.returncode}): {proc.stderr.strip()[-2000:]}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        for fn in (lib.fs_load_batch, lib.fs_load_depth_batch):
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ]
        _lib = lib
    except (OSError, RuntimeError) as exc:  # no g++, no libjpeg/libpng, no loader
        _error = f"{type(exc).__name__}: {exc}"
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the decoder is unavailable, or None when it is available."""
    _load()
    return _error


def decoder_name() -> str:
    """``"native"`` when the frame loaders decode with this library, else
    ``"pil"``."""
    return "native" if available() else "pil"


def _run(entry: str, paths: list[str], shape: tuple[int, ...]) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_error}")
    n = len(paths)
    out = np.empty((n, *shape), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = getattr(lib, entry)(
        arr, n, shape[0], shape[1], out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"native decoder failed on one of {n} files: {paths}")
    return out


def load_jpeg_batch(paths: list[str], out_h: int, out_w: int) -> np.ndarray:
    """Decode + Lanczos-resize JPEGs in parallel -> (n, h, w, 3) f32 [0,1]."""
    return _run("fs_load_batch", paths, (out_h, out_w, 3))


def load_depth_batch(paths: list[str], out_h: int, out_w: int) -> np.ndarray:
    """Decode + PIL-BICUBIC-resize 8/16-bit grayscale PNGs in parallel ->
    (n, h, w) f32 in raw sample units (e.g. ScanNet millimeters)."""
    return _run("fs_load_depth_batch", paths, (out_h, out_w))
