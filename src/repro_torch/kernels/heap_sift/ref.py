"""Oracle for the sift-wavefront kernel: the paper's sequential execution SE.

Thm 2's proof reduces the parallel ExtractMin phase to a *sequential*
execution of sift-downs from the start nodes in non-increasing depth order
(deepest first).  This oracle performs exactly that with a plain numpy
binary heap sift — the kernel result must match element-wise.
"""
from __future__ import annotations

import numpy as np


def sift_down_sequential(a: np.ndarray, size: int, start: int) -> None:
    """Classic Gonnet–Munro sift-down, in place.  1-indexed array heap."""
    v = start
    while True:
        l, r = 2 * v, 2 * v + 1
        best, bv = v, a[v]
        if l <= size and a[l] < bv:
            best, bv = l, a[l]
        if r <= size and a[r] < bv:
            best, bv = r, a[r]
        if best == v:
            return
        a[v], a[best] = a[best], a[v]
        v = best


def sift_wavefront_reference(a: np.ndarray, size: int,
                             starts: np.ndarray,
                             active: np.ndarray) -> np.ndarray:
    """SE order: sift from active start nodes, deepest first (stable)."""
    a = a.copy()
    order = sorted(
        (i for i in range(len(starts)) if active[i]),
        key=lambda i: -int(np.floor(np.log2(max(int(starts[i]), 1)))),
    )
    for i in order:
        sift_down_sequential(a, int(size), int(starts[i]))
    return a
