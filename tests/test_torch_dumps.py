"""``run_test``'s PNG dumps on writer threads (``evaluation/harness.py::
_PngWriter``), on the CPU with tiny scenes.

Every file is on disk when ``run_test`` returns, with the bytes a plain
serial Pillow save of the same array gives; the loop takes the next scene
while the last one's files are still being written, waits for them before
handing over its own (so no two scenes' files are in the pool at once), and
hands the writers numpy arrays only; a writer's error, or a scene's, is
raised from ``run_test`` and leaves no writer thread behind; ``png_hidden``
counts the files written before the loop came to wait for them.
"""
import collections
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait

import numpy as np
import pytest
import torch
from PIL import Image

from freesplat_tpu_torch.config.config import load_config
from freesplat_tpu_torch.evaluation import harness
from freesplat_tpu_torch.evaluation.harness import run_test
from freesplat_tpu_torch.training.trainer import TrainCfg, init_state
from freesplat_tpu_torch.utils.profiling import Recorder, recording
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_spans import _scene, fast_init  # noqa: F401  (fixture)

ARGS = ["+experiment=scannet/2views", "encoder.num_depth_candidates=8",
        "dataset.image_shape=[32,32]", "test.encode_view_chunk=2"]
FILES = 2 * 2 + 4 + 4 + 2  # a scene's colour, ground truth, context and depth maps


def _cfg_and_state(out):
    cfg = load_config(ARGS + [f"test.output_path={out}"])
    state = init_state(TrainCfg(encoder=cfg.encoder), seed=5, device="cpu")["encoder"]
    return cfg, state.state_dict()


def _plain_png(array: np.ndarray, path) -> bytes:
    """The serial dumps' file: clip, times 255, truncate, Pillow's defaults."""
    Image.fromarray((np.clip(array, 0, 1) * 255).astype(np.uint8)).save(path)
    return path.read_bytes()


def _holds_tensor_on(array) -> set[str]:
    """The devices of the tensors ``array``'s chain of bases keeps alive."""
    base = array
    while isinstance(base, np.ndarray):
        base = base.base
    return {base.device.type} if isinstance(base, torch.Tensor) else set()


def test_dumps_overlap_the_next_scene_and_match_a_serial_save(tmp_path, monkeypatch, fast_init):
    out = tmp_path / "out"
    cfg, state = _cfg_and_state(out)
    lock = threading.Lock()
    pending = collections.Counter()  # files submitted and not yet written, by scene
    submitted: dict = {}  # path -> a copy of the array handed to the writers
    busy_at_submit, busy_at_next, after_stats = [], [], []

    class Watched(ThreadPoolExecutor):
        """One slow writer, so each scene's files outlast the loop's turn to
        the next scene."""

        def __init__(self, workers, **kwargs):
            super().__init__(1, **kwargs)

        def submit(self, fn, array, path):
            assert isinstance(array, np.ndarray) and not isinstance(array, torch.Tensor)
            assert _holds_tensor_on(array) <= {"cpu"}
            scene = path.relative_to(out).parts[0]
            with lock:
                busy_at_submit.append({s for s, n in pending.items() if n and s != scene})
                pending[scene] += 1
            submitted[path] = np.array(array)

            def slow(array, path):
                time.sleep(0.15)  # a scene's files outlast its successor's compute
                written = fn(array, path)
                after_stats.append((out / "stats.json").exists())
                return written

            future = super().submit(slow, array, path)

            def done(_):
                with lock:
                    pending[scene] -= 1

            future.add_done_callback(done)
            return future

    monkeypatch.setattr(harness, "ThreadPoolExecutor", Watched)
    scenes = [_scene(k) for k in (1, 2, 3)]

    def feed():
        for k, batch in enumerate(scenes):
            if k:
                with lock:
                    busy_at_next.append(pending[f"s{k}"])
            yield batch

    run_test(cfg, batches=feed(), state=state, device="cpu")

    # The loop went on while the last scene's files were written, and
    # waited for them before handing over the next scene's.
    assert busy_at_next and all(n > 0 for n in busy_at_next)
    assert len(busy_at_submit) == 3 * FILES and not any(busy_at_submit)
    assert sum(pending.values()) == 0
    assert len(after_stats) == 3 * FILES and not any(after_stats)
    # Every file on disk on return, byte for byte the serial save's.
    written = sorted(p.relative_to(out) for p in out.rglob("*.png"))
    assert written == sorted(p.relative_to(out) for p in submitted)
    assert len(written) == 3 * FILES
    plain = tmp_path / "plain.png"
    for path, array in submitted.items():
        assert path.read_bytes() == _plain_png(array, plain), path
    for k, batch in enumerate(scenes, 1):
        for vi, image in enumerate(batch["context"]["image"][0]):
            np.testing.assert_array_equal(submitted[out / f"s{k}" / "context" / f"{vi:04}.png"],
                                          image)
    assert (out / "stats.json").exists()


@pytest.mark.parametrize("fault", ["first_scene_files", "last_scene_files", "a_scene"])
def test_an_error_is_raised_and_no_writer_outlives_the_call(tmp_path, fault, fast_init):
    out = tmp_path / "out"
    cfg, state = _cfg_and_state(out)
    out.mkdir()
    scenes = [_scene(k) for k in (1, 2, 3)]
    if fault == "first_scene_files":
        (out / "s1").write_text("")  # a file where the scene's folder goes
    if fault == "last_scene_files":
        (out / "s3").write_text("")

    def feed():
        yield from scenes[:2]
        if fault == "a_scene":
            raise RuntimeError("the feed broke")
        yield scenes[2]

    before = set(threading.enumerate())
    with pytest.raises(RuntimeError if fault == "a_scene" else OSError):
        run_test(cfg, batches=feed(), state=state, device="cpu")
    assert set(threading.enumerate()) == before
    assert not (out / "stats.json").exists()
    if fault == "a_scene":  # the files handed over before the error are written
        assert len(list((out / "s2").rglob("*.png"))) == FILES


def test_png_hidden_counts_the_files_written_before_the_wait(tmp_path, monkeypatch):
    gate = threading.Event()
    write = harness._write_png

    def gated(array, path):
        if path.name == "late.png":
            assert gate.wait(30)
        return write(array, path)

    monkeypatch.setattr(harness, "_write_png", gated)
    image = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32)
    rec = Recorder(events=False)
    pngs = harness._PngWriter()
    opener = threading.Timer(0.2, gate.set)
    try:
        with recording(rec):
            pngs.submit("a", [("color", image, tmp_path / "a" / "early.png"),
                              ("gt", image, tmp_path / "a" / "late.png")])
            futures_wait([pngs._jobs[0][1]], timeout=30)
            opener.start()  # the late file ends while the loop waits for it
            pngs.submit("b", [("context", image, tmp_path / "b" / "early.png")])
            futures_wait([pngs._jobs[0][1]], timeout=30)
            pngs.wait()
    finally:
        opener.cancel()
        gate.set()
        pngs.close()
    assert rec.totals("png_hidden") == {"a": 1, "b": 1}
    assert rec.totals("png_files") == {"a": 2, "b": 1}
    sizes = {u: sum(p.stat().st_size for p in (tmp_path / u).glob("*.png")) for u in "ab"}
    assert rec.totals("png_bytes") == sizes
    kinds = collections.Counter((c.unit, c.attrs["kind"]) for c in rec.counters
                                if c.name == "png_ms")
    assert kinds == {("a", "color"): 1, ("a", "gt"): 1, ("b", "context"): 1}
    assert [s.name for s in rec.spans] == ["dumps.wait"] * 3
