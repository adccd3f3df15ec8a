"""The port's native frame decoder (``freesplat_tpu_torch/native``) against
the JAX package's library and against PIL, on the CPU.

The port builds its own copy of ``dataloader.cpp`` with the JAX flags, so
on the same files it must give the JAX library's bits exactly; against
PIL's LANCZOS it is held to JAX's own bounds
(``tests/test_native_loader.py``).  A file it cannot decode raises, and a
failed build leaves the PIL path with its reason.
"""
import numpy as np
import pytest
from PIL import Image

from freesplat_tpu import native as jnative
from freesplat_tpu_torch import native as tnative
from freesplat_tpu_torch.data import scannet as tsc
from freesplat_tpu_torch.data import view_samplers as tvs

ROOT = tnative.SRC.parents[2]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """JPEGs (one at ScanNet's native 1296x968: 16-pixel patches in
    [0.15, 0.85] with noise, no pixel saturated; small random ones) and
    16-bit depth PNGs."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    coarse = rng.uniform(0.15, 0.85, size=(61, 81, 3))
    big = np.repeat(np.repeat(coarse, 16, axis=0), 16, axis=1)[:968, :1296]
    big = big + 0.03 * rng.standard_normal(big.shape)
    jpegs = [d / "big.jpg"]
    Image.fromarray((255 * big).astype(np.uint8), "RGB").save(jpegs[0], quality=95)
    for i in range(3):
        jpegs.append(d / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8), "RGB").save(
            jpegs[-1], quality=95)
    pngs = []
    for i in range(3):
        pngs.append(d / f"{i}.png")
        Image.fromarray(rng.integers(400, 6000, (48, 64)).astype(np.uint16)).save(pngs[-1])
    return [str(p) for p in jpegs], [str(p) for p in pngs]


def test_decoder_builds_outside_the_package():
    assert tnative.available(), tnative.build_error()
    assert tnative.decoder_name() == "native" and tnative.build_error() is None
    lib = tnative.library_path()
    assert lib.exists() and lib.parent == ROOT / "build" / "native"
    assert not list(tnative.SRC.parent.glob("*.so"))
    # Same bytes as the JAX source apart from comments.
    strip = lambda p: [c for c in (ln.split("//")[0].rstrip()  # noqa: E731
                                   for ln in p.read_text().splitlines()) if c]
    assert strip(tnative.SRC) == strip(jnative._SRC)


def test_library_path_changes_with_the_host_isa(monkeypatch):
    """A build directory carried to a CPU with other instructions does not
    load the first host's library: ``-march=native`` is in the name."""
    here = tnative.library_path()
    monkeypatch.setattr(tnative, "host_isa", lambda: "  -march=  some-other-cpu\n")
    there = tnative.library_path()
    assert there != here and there.parent == here.parent


@pytest.mark.parametrize("shape", [(480, 640), (24, 32)])
def test_jpeg_batch_equals_jax_library(frames, shape):
    """Bit-equal to the JAX package's decoder on the same files: 968x1296
    to ScanNet's 640x480 load size, and 48x64 frames down to 24x32."""
    jpegs, _ = frames
    paths = jpegs[:1] if shape == (480, 640) else jpegs[1:]
    assert jnative.available()
    ours = tnative.load_jpeg_batch(paths, *shape)
    theirs = jnative.load_jpeg_batch(paths, *shape)
    assert ours.dtype == np.float32 and ours.shape == (len(paths), *shape, 3)
    np.testing.assert_array_equal(ours, theirs)


def test_depth_batch_equals_jax_library(frames):
    _, pngs = frames
    ours = tnative.load_depth_batch(pngs, 24, 32)
    np.testing.assert_array_equal(ours, jnative.load_depth_batch(pngs, 24, 32))
    assert ours.shape == (3, 24, 32)


def test_decoder_matches_pil_lanczos(frames):
    """JAX's bounds (tests/test_native_loader.py): PIL rounds to uint8
    between its two passes, the decoder keeps double precision (measured
    1.07/255 max, 0.29/255 mean on the 1296x968 frame).  Where the frame
    saturates, PIL also clips the first pass's overshoot and the decoder
    clamps once at the end: patches in [0, 1] with noise 0.05, clipped to
    [0, 1], read 9.3/255 max, 0.29/255 mean (JAX's decoder alike)."""
    jpegs, pngs = frames
    for paths, (h, w) in ((jpegs[:1], (480, 640)), (jpegs[1:], (24, 32))):
        out = tnative.load_jpeg_batch(paths, h, w)
        ref = np.stack([np.asarray(Image.open(p).resize((w, h), Image.LANCZOS)).astype(
            np.float32) / 255.0 for p in paths])
        assert float(np.abs(out - ref).max()) < 6.0 / 255.0
        assert float(np.abs(out - ref).mean()) < 0.5 / 255.0
    depth = tnative.load_depth_batch(pngs, 24, 32)
    ref = np.stack([np.asarray(Image.open(p).resize((32, 24))).astype(np.float32) for p in pngs])
    assert float(np.abs(depth - ref).max()) <= 1.5  # raw units; PIL rounds between passes


def test_bad_file_raises_and_the_loader_does_not_fall_back(tmp_path, frames):
    junk = tmp_path / "junk.png"
    junk.write_bytes(b"not an image")
    with pytest.raises(RuntimeError, match="native decoder failed"):
        tnative.load_depth_batch([str(junk)], 8, 8)
    with pytest.raises(RuntimeError, match="native decoder failed"):
        tnative.load_jpeg_batch([frames[0][1], str(junk)], 8, 8)
    # A ScanNet frame that the built decoder cannot read raises instead of
    # being decoded again by PIL (JAX's loader falls back).
    scene = tmp_path / "train" / "scene0"
    (scene / "color").mkdir(parents=True)
    (scene / "color" / "0.jpg").write_bytes(b"\xff\xd8 truncated")
    ds = tsc.DatasetScannet(
        tsc.DatasetScannetCfg(roots=(str(tmp_path),), load_size=(24, 32)), "train",
        tvs.ViewSamplerAll())
    with pytest.raises(RuntimeError, match="native decoder failed"):
        ds._load_frames(scene, [0])


def test_failed_build_reads_back_as_pil(tmp_path, monkeypatch):
    """A source that does not compile: the decoder is unavailable, the
    reason is kept, the loaders take PIL and nothing is written into the
    package."""
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    assert not tnative.available()
    assert tnative.decoder_name() == "pil"
    assert "g++ failed" in tnative.build_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.load_jpeg_batch([], 8, 8)
    assert not list((tmp_path / "build").glob("*.so"))
