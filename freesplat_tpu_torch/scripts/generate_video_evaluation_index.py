"""CLI: derive a video evaluation index from a frozen evaluation index.

Port of ``freesplat_tpu/scripts/generate_video_evaluation_index.py``
(parity target ``src/scripts/generate_video_evaluation_index.py``): for
each scene with a 2-context entry, the video index keeps the same context
pair and targets *every* intermediate frame between them, so rendering
the index produces a smooth interpolation video.  Runs on the host: no
tensor is involved.

Run: ``python -m freesplat_tpu_torch.scripts.generate_video_evaluation_index \
    <input_index.json> <output_index.json>``
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def videoize_index(index: dict) -> dict:
    """Context pair kept; targets become the full inclusive frame range."""
    out = {}
    for scene, entry in index.items():
        if entry is None:
            out[scene] = None
            continue
        context = entry["context"]
        a, b = min(context), max(context)
        out[scene] = {"context": list(context), "target": list(range(a, b + 1))}
    return out


def main(argv: list[str] | None = None) -> None:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 2:
        print(
            "usage: python -m freesplat_tpu_torch.scripts."
            "generate_video_evaluation_index <in.json> <out.json>",
            file=sys.stderr,
        )
        raise SystemExit(2)
    src, dst = Path(args[0]), Path(args[1])
    out = videoize_index(json.loads(src.read_text()))
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(json.dumps(out))
    print(f"wrote {dst} ({len(out)} scenes)")


if __name__ == "__main__":
    main()
