"""Skip-list priority queue baseline (Fig. 2's fine-grained rivals).

The paper benchmarks four Java skip-list PQs (Lazy SL, SkipQueue, Linden
SL).  Fine-grained Java lock/CAS protocols don't transfer to CPython (GIL,
no CAS); we keep the *data structure* (skip list ⇒ O(log n) ordered ops,
extract-min at the head) and expose the same ``apply`` interface so it can
be driven through the Lock / FC wrappers — the structural baseline the
ranking claim needs (see DESIGN.md §8.4).
"""
from __future__ import annotations

import random
from typing import Any, List, Optional

_MAX_LEVEL = 24
_P = 0.5


class _Node:
    __slots__ = ("key", "next")

    def __init__(self, key: float, level: int):
        self.key = key
        self.next: List[Optional["_Node"]] = [None] * level


class SkipListPQ:
    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._head = _Node(float("-inf"), _MAX_LEVEL)
        self._level = 1
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def _random_level(self) -> int:
        lvl = 1
        while self._rng.random() < _P and lvl < _MAX_LEVEL:
            lvl += 1
        return lvl

    def insert(self, key: float) -> None:
        update = [self._head] * _MAX_LEVEL
        node = self._head
        for i in range(self._level - 1, -1, -1):
            while node.next[i] is not None and node.next[i].key < key:
                node = node.next[i]
            update[i] = node
        lvl = self._random_level()
        if lvl > self._level:
            self._level = lvl
        new = _Node(key, lvl)
        for i in range(lvl):
            new.next[i] = update[i].next[i]
            update[i].next[i] = new
        self._size += 1

    def extract_min(self) -> Optional[float]:
        first = self._head.next[0]
        if first is None:
            return None
        for i in range(len(first.next)):
            self._head.next[i] = first.next[i]
        self._size -= 1
        return first.key

    def apply(self, method: str, input: Any = None) -> Any:
        if method == "insert":
            return self.insert(input)
        if method == "extract_min":
            return self.extract_min()
        raise ValueError(f"unknown method {method!r}")
