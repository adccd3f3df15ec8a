"""Heterogeneous view pairings (all pairs except self-pairs).

A copy of ``freesplat_tpu/geometry/pairings.py`` (numpy; reference
``src/misc/heterogeneous_pairings.py``): ``generate_heterogeneous_index``
lists, for each of ``n`` views, the other views it is paired with (all
others for n <= 3, a sliding window of 2 neighbours beyond), and the
``_transpose`` variant gives the (view, pair-slot) addresses that invert
the pairing.  The transpose is built for any n: positions are found by
search, and rows with fewer than the full count of inverse pairs repeat
their last entry (the reference's fallback).
"""
from __future__ import annotations

import numpy as np


def generate_heterogeneous_index(n: int, window: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Returns (index_self, index_other), each (n, ov) int32.

    For n <= 3: ov = n - 1 and row i lists all j != i ascending.  For n > 3:
    ov = ``window`` and row i keeps only the window of nearest sequence
    neighbours."""
    base_other = np.array([[j for j in range(n) if j != i] for i in range(n)], np.int32)

    if n <= 3:
        index_other = base_other
    else:
        cols = np.empty((n, window), np.int64)
        for i in range(n):
            # The reference's slide_mask: clamp an i-centred window of
            # ``window`` columns into [0, n - 1).
            if i < window // 2:
                start = 0
            elif i >= n - window // 2 - 1:
                start = max(n - window - 1, 0)
            else:
                start = max(i - window // 2, 0)
            cols[i] = np.arange(start, start + min(window, n))
        index_other = np.take_along_axis(base_other, cols, axis=1)

    index_self = np.broadcast_to(np.arange(n)[:, None], index_other.shape).astype(np.int32)
    return index_self, index_other.astype(np.int32)


def generate_heterogeneous_index_transpose(
    n: int, window: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (t_v, t_ov): ``x[t_v[i, k], t_ov[i, k]]`` is the pair slot
    where view ``t_v`` looks at view ``i``; applying it to a (view,
    other_view, ...) tensor swaps "ray-casting view" for "sampled view"."""
    _, index_other = generate_heterogeneous_index(n, window)
    ov = index_other.shape[1]
    t_v = np.zeros((n, ov), np.int32)
    t_ov = np.zeros((n, ov), np.int32)
    for i in range(n):
        hits = [(j, k) for j in range(n) for k in range(ov) if index_other[j, k] == i]
        if not hits:
            hits = [(min(i + 1, n - 1), 0)]  # degenerate window (tiny n)
        while len(hits) < ov:
            hits.append(hits[-1])  # the reference's duplicated-edge fallback
        for k in range(ov):
            t_v[i, k], t_ov[i, k] = hits[k]
    return t_v, t_ov
