"""Gonnet–Munro sequential binary heap (§4 'sequential algorithm').

1-indexed array heap.  ``insert`` walks root→new-leaf swapping the carried
value downward (top-down insertion, as the paper describes); ``extract_min``
swaps the tail into the root and sifts down.  Used as (a) the flat-combining
base structure, (b) the oracle for the batched heap's property tests.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional


class SequentialHeap:
    def __init__(self):
        self.a: List[float] = [float("-inf")]  # index 0 unused

    # -- helpers -----------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.a) - 1

    def __len__(self) -> int:
        return self.size

    def values(self) -> List[float]:
        return sorted(self.a[1:])

    def check_heap_property(self) -> bool:
        for v in range(2, self.size + 1):
            if self.a[v >> 1] > self.a[v]:
                return False
        return True

    # -- operations ----------------------------------------------------------
    def insert(self, x: float) -> None:
        self.a.append(None)  # placeholder at position size+1
        target = self.size
        val = x
        # walk the root→target path, swapping val downward (Gonnet–Munro)
        path = []
        v = target
        while v >= 1:
            path.append(v)
            v >>= 1
        for v in reversed(path):
            if v == target:
                self.a[v] = val
                return
            if val < self.a[v]:
                val, self.a[v] = self.a[v], val

    def extract_min(self) -> Optional[float]:
        if self.size == 0:
            return None
        res = self.a[1]
        last = self.a.pop()
        if self.size == 0:
            return res
        self.a[1] = last
        self._sift_down(1)
        return res

    def _sift_down(self, v: int) -> None:
        n = self.size
        while True:
            l, r = 2 * v, 2 * v + 1
            smallest = v
            if l <= n and self.a[l] < self.a[smallest]:
                smallest = l
            if r <= n and self.a[r] < self.a[smallest]:
                smallest = r
            if smallest == v:
                return
            self.a[v], self.a[smallest] = self.a[smallest], self.a[v]
            v = smallest

    # -- generic apply (for FC / Lock wrappers) -----------------------------
    def apply(self, method: str, input: Any = None) -> Any:
        if method == "insert":
            return self.insert(input)
        if method == "extract_min":
            return self.extract_min()
        raise ValueError(f"unknown method {method!r}")
