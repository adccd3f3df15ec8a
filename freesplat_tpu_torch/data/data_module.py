"""Stage-aware data orchestration (the Lightning DataModule equivalent).

Behavioral parity target: ``src/dataset/data_module.py`` (130 LoC) — builds
per-stage loaders with deterministic seeding, wraps validation in a
one-random-sample-per-pass view (reference ``validation_wrapper.py:7-32``).
The encoder's batch shim hook (``data_module.py:21-36``) is left out:
FreeSplat's shim is the identity (``encoder/encoder.py:27-29``).

A copy of ``freesplat_tpu/data/data_module.py`` for map-style datasets
(the iterable, chunk-streamed RE10K path is not ported yet).  Differences
from the reference:

- No worker processes: training is a single host process per device, so
  the loader runs on a background *thread* (``Prefetcher``) that overlaps
  host-side decode/collate with device compute.
- The reference's shared-memory ``StepTracker`` (``misc/step_tracker.py``)
  collapses to a plain ``step_fn`` callable: samplers run in-process, so
  the curriculum just reads the trainer's step directly.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from ..parallel.distributed import process_rank
from .scannet import collate


@dataclass
class DataLoaderStageCfg:
    batch_size: int = 1
    seed: int = 1234


class ValidationWrapper:
    """Yields one random example per validation pass.

    Reference ``validation_wrapper.py:7-32``: wraps the val dataset in a
    length-1 view whose single item is drawn fresh each epoch, so every
    validation step sees a different scene without iterating the full set.
    """

    def __init__(self, dataset, seed: int = 0):
        self.dataset = dataset
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return 1

    def __iter__(self) -> Iterator[dict]:
        while True:
            idx = int(self.rng.integers(len(self.dataset)))
            yield self.dataset[idx]


class Prefetcher:
    """Background-thread prefetch with a bounded queue.

    Replaces torch DataLoader worker processes: host-side load/collate for
    batch k+1..k+depth overlaps device compute on batch k.  The thread is a
    daemon; ``close()`` stops it early.
    """

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            try:
                for item in iterator:
                    while not self._stop.is_set():
                        try:
                            self._queue.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            finally:
                self._queue.put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()


class DataModule:
    """Builds per-stage batch iterators from a dataset factory.

    ``dataset_factory(stage)`` returns a map-style dataset (``__len__`` /
    ``__getitem__`` -> example dict).  ``step_fn`` feeds the
    curriculum sampler the current global step.
    """

    def __init__(
        self,
        dataset_factory: Callable[[str], object],
        loader_cfg: DataLoaderStageCfg | None = None,
        step_fn: Optional[Callable[[], int]] = None,
        prefetch: int = 2,
    ):
        self.dataset_factory = dataset_factory
        self.cfg = loader_cfg or DataLoaderStageCfg()
        self.step_fn = step_fn
        self.prefetch = prefetch

    def _stream(self, dataset, *, shuffle: bool, loop: bool) -> Iterator[dict]:
        rank, world = process_rank()
        rng = np.random.default_rng(self.cfg.seed)
        bs = self.cfg.batch_size

        def maybe_set_step():
            if self.step_fn is not None and hasattr(
                getattr(dataset, "view_sampler", None), "set_step"
            ):
                dataset.view_sampler.set_step(self.step_fn())

        while True:
            order = (
                rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
            )
            # Multi-process: each process takes a disjoint strided share
            # of each epoch.
            order = order[rank::world]
            for start in range(0, len(order) - bs + 1, bs):
                maybe_set_step()
                yield collate([dataset[int(i)] for i in order[start : start + bs]])
            if not loop:
                return

    def train_batches(self) -> Iterator[dict]:
        it = self._stream(self.dataset_factory("train"), shuffle=True, loop=True)
        return Prefetcher(it, self.prefetch) if self.prefetch else it

    def val_batches(self) -> Iterator[dict]:
        wrapper = ValidationWrapper(
            self.dataset_factory("val"), seed=self.cfg.seed + 1
        )
        it = iter(wrapper)

        def stream():
            for example in it:
                yield collate([example])

        return stream()

    def test_batches(self) -> Iterator[dict]:
        return self._stream(
            self.dataset_factory("test"), shuffle=False, loop=False
        )
