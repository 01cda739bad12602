"""Tensor helpers shared by the heap kernels' plain versions and the pass.

Every function here works on a leading shard axis: a heap stack is
``(K, cap)`` float32 with +inf in empty slots and ``a[:, 0]`` as the +inf
scratch slot; the single heap is the ``K = 1`` case.
"""
from __future__ import annotations

import math

import numpy as np
import torch

INF = math.inf
TINY = float(np.finfo(np.float32).tiny)         # smallest normal f32


def depth(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(v, 1))), exactly: ``frexp`` of the float64 image
    (every int32 is exact in float64), never a float32 ``log2``."""
    _, e = torch.frexp(torch.clamp(v, min=1).to(torch.float64))
    return (e - 1).to(torch.int32)


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[k, idx[k, j]]`` with ``idx`` clipped into ``[0, cap)``."""
    cap = a.shape[-1]
    return a.gather(-1, idx.clamp(0, cap - 1).long())


def gather_masked(a: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """``a[k, idx]`` where ``valid``, +inf elsewhere (``batched_pq._gather``)."""
    return torch.where(valid, take(a, idx), INF)


def put(a: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """In-place ``a[k, idx[k, j]] = vals[k, j]``.  Masked lanes aim at the
    scratch slot 0, which is reset to +inf afterwards, so duplicate writes
    there are harmless whichever of them lands."""
    a.scatter_(-1, idx.long(), vals)
    a[..., 0] = INF
