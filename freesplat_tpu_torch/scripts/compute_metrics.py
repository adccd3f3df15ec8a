"""CLI: tabulate metrics over dumped frames of multiple methods.

Port of ``freesplat_tpu/scripts/compute_metrics.py`` (parity target
``src/scripts/compute_metrics.py``).

Run (the GPU unless ``--device cpu``):
  python -m freesplat_tpu_torch.scripts.compute_metrics \
      ours=outputs/test baseline=outputs/baseline
"""
from __future__ import annotations

import sys

from ..evaluation.metric_computer import (
    MethodCfg,
    MetricComputerCfg,
    run_metric_computer,
)


def main(argv: list[str] | None = None, device: str | None = None) -> dict:
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--device" in argv:
        i = argv.index("--device")
        device = device or argv[i + 1]
        del argv[i:i + 2]
    methods = []
    for arg in argv:
        name, _, path = arg.partition("=")
        if not path:
            raise SystemExit(f"expected name=path, got '{arg}'")
        methods.append(MethodCfg(name=name, key="", path=path))
    if not methods:
        raise SystemExit("usage: compute_metrics name=path [name=path ...] [--device cpu]")
    return run_metric_computer(MetricComputerCfg(methods=tuple(methods)),
                               device=device or "cuda")


if __name__ == "__main__":
    main()
