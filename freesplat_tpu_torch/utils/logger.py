"""Local experiment logger (reference ``src/misc/LocalLogger.py:12-48``):
writes scalar logs to a JSONL file under ``outputs/local``, with optional
tensorboardX event files.  A copy of ``freesplat_tpu/utils/logger.py``
(its image logging is not ported yet).
"""
from __future__ import annotations

import json
import time
from pathlib import Path

LOG_PATH = Path("outputs/local")


class LocalLogger:
    def __init__(self, output_dir: str | Path = LOG_PATH, use_tensorboard: bool = True):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._scalar_file = (self.dir / "metrics.jsonl").open("a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(str(self.dir / "tb"))
            except Exception:
                self._tb = None

    def log_scalars(self, step: int, scalars: dict[str, float]) -> None:
        record = {"step": int(step), "time": time.time(), **{
            k: float(v) for k, v in scalars.items()
        }}
        self._scalar_file.write(json.dumps(record) + "\n")
        self._scalar_file.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._scalar_file.close()
        if self._tb is not None:
            self._tb.close()
