"""Sequential counting/top-k sketch — the host tier + differential
oracle for the device-resident batched sketch (DESIGN.md §16).

The port of ``repro.core.seq_sketch`` with the same semantics.  The
reference's ``topk`` sorts the whole table in Python on every call; this
copy ranks with numpy (a partition to the k-th largest count, then a
lexsort of the candidates) and returns the same list, so it stays usable
as the oracle at a million counters.

A bounded table of ``key -> count`` counters with integer-valued f32
weights (exact f32 sums by construction, so the device tier's vectorized
adds can be compared bit-for-bit).  ``add`` returns True iff the op
*created* the counter; reads are ``count`` / ``total`` / ``distinct`` /
``topk`` (descending count, ascending-key tie-break — the deterministic
order both tiers share).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Set, Tuple

import numpy as np

from .batched_pq import _TINY
from .sharded_pq import host_key


def _qk(x: float) -> float:
    """The exact f32 key image the device sketch stores (DESIGN.md §7)."""
    k = float(np.float32(x))
    if np.isnan(k) or np.isinf(k):
        raise ValueError("sketch keys must be finite f32")
    return host_key(k)


def _qw(w: float) -> float:
    """Weights are positive integers stored as f32 (exact sums)."""
    wi = int(w)
    if wi < 1 or wi != w:
        raise ValueError("sketch weights must be positive integers")
    return float(np.float32(wi))


def quantize_items(items) -> Tuple[np.ndarray, np.ndarray]:
    """``_qk`` and ``_qw`` over all (key, weight) pairs at once, summed
    per key: the ascending distinct f32 key images and their count sums
    (float64, integer-valued, so exact in any order) — what adding the
    pairs one by one gives, at numpy speed for a million counters."""
    pairs = np.asarray(list(items), np.float64).reshape(-1, 2)
    with np.errstate(over="ignore"):          # out of f32 range -> inf
        keys = pairs[:, 0].astype(np.float32)
    if not np.all(np.isfinite(keys)):
        raise ValueError("sketch keys must be finite f32")
    keys = np.where(np.abs(keys) < _TINY, np.float32(0.0), keys)
    w = pairs[:, 1]
    if not np.all(np.isfinite(w) & (w >= 1) & (w == np.trunc(w))):
        raise ValueError("sketch weights must be positive integers")
    ks, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv.reshape(-1), minlength=ks.size,
                       weights=w.astype(np.float32).astype(np.float64))
    return ks, sums


class SequentialSketch:
    """Pure-python counter table; the batched sketch's oracle/host tier."""

    read_only: Set[str] = {"count", "total", "distinct", "topk"}

    def __init__(self, items=None):
        ks, sums = quantize_items(items or ())
        self._c: Dict[float, float] = dict(zip(ks.tolist(), sums.tolist()))

    def __len__(self) -> int:
        return len(self._c)

    # -- updates -------------------------------------------------------------
    def add(self, key: float, w: float = 1.0) -> bool:
        k, wq = _qk(key), _qw(w)
        created = k not in self._c
        self._c[k] = self._c.get(k, 0.0) + wq
        return created

    # -- reads ---------------------------------------------------------------
    def count(self, key: float) -> float:
        return float(self._c.get(_qk(key), 0.0))

    def total(self) -> float:
        return float(sum(self._c.values()))

    def distinct(self) -> int:
        return len(self._c)

    def topk(self, k: int) -> List[Tuple[float, float]]:
        """Top-k (key, count) pairs, count descending, key ascending."""
        k = int(k)
        n = len(self._c)
        if k <= 0 or n == 0:
            return []
        keys = np.fromiter(self._c.keys(), np.float64, n)
        counts = np.fromiter(self._c.values(), np.float64, n)
        if k < n:                  # only counts >= the k-th largest rank
            kth = -np.partition(-counts, k - 1)[k - 1]
            cand = counts >= kth
            keys, counts = keys[cand], counts[cand]
        order = np.lexsort((keys, -counts))[:k]
        return [(float(keys[i]), float(counts[i])) for i in order]

    # -- batch facade (protocol-shaped, for the adaptive tier / kit) ---------
    def apply(self, method: str, input: Any = None) -> Any:
        if method == "add":
            return self.add(*input)
        if method == "count":
            return self.count(input)
        if method == "total":
            return self.total()
        if method == "distinct":
            return self.distinct()
        if method == "topk":
            return self.topk(input)
        raise ValueError(f"unknown method {method!r}")

    def update_batch(self, methods: Sequence[str],
                     inputs: Sequence[Any]) -> List[Any]:
        return [self.apply(m, i) for m, i in zip(methods, inputs)]

    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        return [self.apply(m, i) for m, i in zip(methods, inputs)]

    def items(self) -> List[Tuple[float, float]]:
        """Live (key, count) pairs ascending by key."""
        return sorted((float(k), float(v)) for k, v in self._c.items())
