"""``calibrate.py`` for the cells whose mix's entry is ``fit_fvt``: the same
readings (the TF32 control and training's planted faults), of the
reference that entry compares the program with.

    python3 perfbench/calibrate_fvt.py --workload fvt8-train --seeds 11 12 13 [--device cuda]
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import calibrate  # noqa: E402
from perfbench.entries.fit_fvt import finite_reference  # noqa: E402


def readings(cell, seed: int, device, out_dir: Path):
    """(variant, {number compared: reading}) of ``cell`` at ``seed``."""
    with finite_reference():
        return list(calibrate.train_readings(cell, seed, device))


if __name__ == "__main__":
    calibrate.readings = readings
    sys.exit(calibrate.main())
