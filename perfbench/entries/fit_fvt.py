"""The ``fit`` entry (``fit.py``), compared with the reference of
``reference/finite_backward.py``: the frozen one with a finite backward
where a step's logits are extreme, as the port's training path has it.
The program's side, the window, the comparison and its limits are
``fit.py``'s; the reference differs from the frozen one only where the
frozen one's gradient is NaN, and its forward only where a PTF merge's
two densities sum to at most 1e-18.

A program without those two guards cannot run this configuration: on
about one seed in ten its gradients are NaN, and where densities are
under 1e-17 its PTF averages place Gaussians where the reference does
not.  ``run`` refuses such a program before set-up (``require_guards``).
"""
from __future__ import annotations

import contextlib

from ..harness import Cell, Run
from ..reference import finite_backward, model
from . import common, fit


@contextlib.contextmanager
def finite_reference():
    """Inside, ``common.load_reference`` (which ``fit.py`` and
    ``calibrate.py`` build the reference with) returns the encoder held by
    ``finite_backward.hold``, and the reference's encoder fuses its views
    with ``finite_backward.fuse_views``."""
    load, fuse = common.load_reference, model.fuse_views

    def load_reference(*args, **kwargs):
        encoder, lpips = load(*args, **kwargs)
        return finite_backward.hold(encoder), lpips

    common.load_reference, model.fuse_views = load_reference, finite_backward.fuse_views
    try:
        yield
    finally:
        common.load_reference, model.fuse_views = load, fuse


def require_guards() -> None:
    """Raise unless the program holds the scale logits and weighs PTF's
    averages as ``finite_backward`` does."""
    from freesplat_tpu_torch.models import adapter, ptf

    want = {(adapter, "SCALE_LOGIT_MIN"): finite_backward.FLOOR,
            (ptf, "DENSITY_FLOOR"): finite_backward.DENSITY_FLOOR}
    wrong = [f"{mod.__name__}.{name}" for (mod, name), value in want.items()
             if getattr(mod, name, None) != value]
    if wrong:
        raise RuntimeError("the program lacks the finite backward this cell's reference has: "
                           + ", ".join(wrong))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    require_guards()
    with finite_reference():
        return fit.run(cell, seed, seconds, trace, device, t_start)
