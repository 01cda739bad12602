"""Sequential union-find — the host tier + differential oracle for the
device-resident batched union-find (DESIGN.md §16).

The port of ``repro.core.seq_union_find`` with the same semantics.
Min-label convention: ``find(u)`` is the smallest vertex id in ``u``'s
component, which makes the canonical labeling unique — the device tier's
min-propagation fixpoint computes exactly the same function, so labels
compare bit-for-bit.

Batch semantics (the pre-batch snapshot rule, mirroring the PQ's
"extracts see the pre-batch multiset"): within one ``update_batch``,
every ``union``'s result is evaluated against the labeling at batch
START — True iff the endpoints were then in different components — and
all unions apply together.  Single-op ``apply`` degenerates to the usual
sequential rule.

The reference relabels the whole vertex list on every merge (O(n) per
union); this copy keeps a forest with union by size, path halving and the
component minimum at each root, so it stays usable as the oracle at a
million vertices.  Answers and labels are the same.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Set, Tuple


class SequentialUnionFind:
    """Pure-python min-label union-find over vertices ``[0, n)``."""

    read_only: Set[str] = {"find", "connected", "components"}

    def __init__(self, n: int):
        if n < 1:
            raise ValueError("n must be >= 1")
        self.n = int(n)
        self._parent = list(range(self.n))
        self._size = [1] * self.n
        self._min = list(range(self.n))     # valid at roots
        self._n_comp = self.n

    def load_labels(self, labels: Sequence[int]) -> None:
        """Take over a canonical (min-label) labeling, e.g. a device
        structure's, as the current state."""
        labels = [int(x) for x in labels]
        if len(labels) != self.n or any(
                not 0 <= l <= x or labels[l] != l
                for x, l in enumerate(labels)):
            raise ValueError("not a canonical min-label labeling")
        self._parent = labels
        self._size = [0] * self.n
        for l in labels:
            self._size[l] += 1
        self._min = list(range(self.n))
        self._n_comp = sum(1 for x, l in enumerate(labels) if x == l)

    def _check(self, u) -> int:
        u = int(u)
        if not 0 <= u < self.n:
            raise ValueError(f"vertex {u} outside [0, {self.n})")
        return u

    def _root(self, x: int) -> int:
        parent = self._parent
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    # -- reads ---------------------------------------------------------------
    def find(self, u: int) -> int:
        return self._min[self._root(self._check(u))]

    def connected(self, u: int, v: int) -> bool:
        return self.find(u) == self.find(v)

    def components(self) -> int:
        return self._n_comp

    # -- updates -------------------------------------------------------------
    def _merge(self, u: int, v: int) -> None:
        ru, rv = self._root(u), self._root(v)
        if ru == rv:
            return
        if self._size[ru] < self._size[rv]:
            ru, rv = rv, ru
        self._parent[rv] = ru
        self._size[ru] += self._size[rv]
        self._min[ru] = min(self._min[ru], self._min[rv])
        self._n_comp -= 1

    def union(self, u: int, v: int) -> bool:
        u, v = self._check(u), self._check(v)
        merged = self._root(u) != self._root(v)
        self._merge(u, v)
        return merged

    # -- batch facade (protocol-shaped) --------------------------------------
    def update_batch(self, methods: Sequence[str],
                     inputs: Sequence[Any]) -> List[Any]:
        edges = []
        for m, i in zip(methods, inputs):
            if m != "union":
                raise ValueError(f"unknown update method {m!r}")
            edges.append((self._check(i[0]), self._check(i[1])))
        # pre-batch snapshot rule: results against the batch-start labels
        out = [self._root(u) != self._root(v) for u, v in edges]
        for u, v in edges:
            self._merge(u, v)
        return out

    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        out: List[Any] = []
        for m, i in zip(methods, inputs):
            if m == "find":
                out.append(self.find(i))
            elif m == "connected":
                out.append(self.connected(*i))
            elif m == "components":
                out.append(self.components())
            else:
                raise ValueError(f"unknown read method {m!r}")
        return out

    def apply(self, method: str, input: Any = None) -> Any:
        if method in self.read_only:
            return self.read_batch([method], [input])[0]
        return self.update_batch([method], [input])[0]

    def labels(self) -> List[int]:
        """The full canonical (min-label) labeling — the state dump."""
        return [self._min[self._root(x)] for x in range(self.n)]

    def edges(self) -> List[Tuple[int, int]]:  # adaptive-tier dump parity
        raise NotImplementedError
