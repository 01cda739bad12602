"""Oracles for the collective-insert kernel.

Two tiers (the parallel insert is NOT element-wise equal to sequential
insertion — siblings may be permuted; the paper's Thm 2 guarantees only the
multiset and the heap property):

1. ``insert_chunk_reference`` — the plain level-synchronous algorithm
   (:func:`~repro_torch.kernels.heap_insert.ops.insert_chunk_plain`): the
   kernel must match this **element-wise** (same placement decisions).
2. ``insert_chunk_sequential`` — classic one-by-one Gonnet–Munro path
   inserts: used to check the *semantics* (multiset equality + heap
   property), which is what Thm 2 promises.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import insert_chunk_plain


def insert_chunk_reference(a, size, chunk_vals, m_chunk):
    """Element-wise oracle on numpy inputs: returns (a, new size)."""
    at = torch.tensor(np.asarray(a, np.float32))[None]
    out, new_size = insert_chunk_plain(
        at, torch.tensor([int(size)], dtype=torch.int32),
        torch.tensor(np.asarray(chunk_vals, np.float32))[None],
        torch.tensor([int(m_chunk)], dtype=torch.int32))
    return out[0].numpy(), int(new_size[0])


def insert_one_sequential(a: np.ndarray, size: int, x: float) -> int:
    """Gonnet–Munro path insert of x; returns the new size."""
    size += 1
    path = []
    v = size
    while v >= 1:
        path.append(v)
        v //= 2
    path.reverse()
    val = x
    for v in path[:-1]:
        if val < a[v]:
            a[v], val = val, a[v]
    a[size] = val
    return size


def insert_chunk_sequential(a: np.ndarray, size: int, vals) -> tuple:
    """Semantic oracle: insert sorted `vals` one by one."""
    a = a.copy()
    for x in vals:
        size = insert_one_sequential(a, size, float(x))
    return a, size
