"""Sequential sorted map — host oracle and flat-combining base structure.

The port of ``repro.core.seq_map`` with the same semantics.  The
reference builds its initial contents by inserting item after item
(``list.insert``, O(n²)); this copy sorts them once (O(n log n), the
first write of a duplicate key wins as with repeated inserts), so it
stays usable as the oracle at a million keys.

A ``SortedDict``-style ordered key→value store over two parallel lists
kept in key order with ``bisect`` (O(n) updates, O(log n) searches).
Three roles, mirroring ``seq_pq.SequentialHeap``:

* the host tier under flat combining / locks (the baseline the device
  map is benchmarked against, the reference's ``benchmarks/bench_map.py``);
* the semantic oracle for the batched map's differential fuzz
  (``tests/test_torch_batched_map.py``);
* the read-path contract: method names and per-op results match
  ``core/batched_map.py`` exactly (insert → "was absent", assign/delete
  → "was present", lookup → value or ``None``, ``range_count``/
  ``range_sum`` over the CLOSED interval [lo, hi], ``kth_smallest`` →
  1-indexed key or ``None``).
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Any, List, Optional, Sequence, Set


class SequentialSortedMap:
    read_only: Set[str] = {"lookup", "range_count", "range_sum",
                           "kth_smallest"}

    def __init__(self, items=None):
        first: dict = {}
        for k, v in items or ():
            first.setdefault(float(k), float(v))   # insert iff absent
        self._keys: List[float] = sorted(first)
        self._vals: List[float] = [first[k] for k in self._keys]

    def __len__(self) -> int:
        return len(self._keys)

    def items(self):
        return list(zip(self._keys, self._vals))

    # -- updates -------------------------------------------------------------
    def insert(self, key: float, value: float) -> bool:
        """Map ``key → value`` iff absent; returns "was absent"."""
        i = bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            return False
        self._keys.insert(i, key)
        self._vals.insert(i, value)
        return True

    def assign(self, key: float, value: float) -> bool:
        """Overwrite the value iff present; returns "was present"."""
        i = bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            self._vals[i] = value
            return True
        return False

    def delete(self, key: float) -> bool:
        """Remove the key iff present; returns "was present"."""
        i = bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            del self._keys[i]
            del self._vals[i]
            return True
        return False

    # -- reads ---------------------------------------------------------------
    def lookup(self, key: float) -> Optional[float]:
        i = bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            return self._vals[i]
        return None

    def range_count(self, lo: float, hi: float) -> int:
        """Number of keys in the closed interval [lo, hi]."""
        return max(0, bisect_right(self._keys, hi)
                   - bisect_left(self._keys, lo))

    def range_sum(self, lo: float, hi: float) -> float:
        """Sum of the values whose keys lie in [lo, hi]."""
        i = bisect_left(self._keys, lo)
        j = bisect_right(self._keys, hi)
        return float(sum(self._vals[i:j]))

    def kth_smallest(self, k: int) -> Optional[float]:
        """The k-th smallest key (1-indexed), ``None`` when out of range."""
        k = int(k)
        if 1 <= k <= len(self._keys):
            return self._keys[k - 1]
        return None

    # -- generic dispatch (flat combining / lock wrappers, fuzz loops) --------
    def apply(self, method: str, input: Any = None) -> Any:
        if method == "insert":
            return self.insert(*input)
        if method == "assign":
            return self.assign(*input)
        if method == "delete":
            return self.delete(input)
        if method == "lookup":
            return self.lookup(input)
        if method == "range_count":
            return self.range_count(*input)
        if method == "range_sum":
            return self.range_sum(*input)
        if method == "kth_smallest":
            return self.kth_smallest(input)
        raise ValueError(f"unknown method {method!r}")

    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        return [self.apply(m, i) for m, i in zip(methods, inputs)]
