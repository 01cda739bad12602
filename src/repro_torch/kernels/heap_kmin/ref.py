"""Oracle for the frontier-search kernel.

Element-wise twin of ``core/batched_pq._k_smallest`` in plain numpy: the
same frontier layout (taken slot replaced by the left child, right child
appended) and the same first-minimum tie-breaking, so the kernel, the XLA
scan, and this oracle must agree element-wise — not just as multisets.
"""
from __future__ import annotations

import numpy as np


def k_smallest_reference(a: np.ndarray, size: int, n_extract: int,
                         c_max: int):
    """Returns (ids (c_max,), vals (c_max,)), ascending, (0, +inf)-padded."""
    F = 2 * c_max + 1
    f_ids = np.zeros(F, np.int32)
    f_vals = np.full(F, np.inf, np.float32)
    f_ids[0] = 1
    f_vals[0] = a[1] if size >= 1 else np.inf
    out_ids = np.zeros(c_max, np.int32)
    out_vals = np.full(c_max, np.inf, np.float32)
    nfree = 1
    for i in range(c_max):
        j = int(np.argmin(f_vals))
        v, val = int(f_ids[j]), float(f_vals[j])
        if i >= n_extract or not np.isfinite(val):
            continue
        l, r = 2 * v, 2 * v + 1
        f_ids[j] = l
        f_vals[j] = a[l] if l <= size else np.inf
        f_ids[nfree] = r
        f_vals[nfree] = a[r] if r <= size else np.inf
        nfree += 1
        out_ids[i] = v
        out_vals[i] = val
    return out_ids, out_vals
