"""Dynamic graph connectivity — the paper's §5.1 read-dominated workload.

The port of ``repro.core.dynamic_graph``: the HOST tier (and the
benchmark baseline).  Interface matches the paper's data type:
``insert(u,v)`` / ``delete(u,v)`` updates and the read-only
``connected(u,v)``.

Substitution recorded in DESIGN.md §8.3: instead of Holm et al.'s polylog
fully-dynamic forest we keep an explicit edge set on the host and rebuild
connected-component labels lazily once per batch by scatter-min + pointer
jumping (plain PyTorch on the structure's device).  Reads are answered by
ONE vectorized gather/compare over the label array.

The rebuild jumps twice per iteration — the reference's ``_components``,
copied as it is; it is not the ``label_step`` of ``kernels/label_prop``,
so it agrees with that kernel only at the fixpoint (the component-min
labeling).  The device-resident tier is ``device_graph.py`` (DESIGN.md
§11).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .batched_pq import resolve_device


def _components(u: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """Connected-component labels via scatter-min + pointer jumping."""
    l = torch.arange(n, dtype=torch.int32, device=u.device)
    u, v = u.long(), v.long()
    while True:
        m = torch.minimum(l[u], l[v])
        l2 = l.clone()
        l2.scatter_reduce_(0, u, m, reduce="amin")
        l2.scatter_reduce_(0, v, m, reduce="amin")
        l2 = l2[l2.long()]
        l2 = l2[l2.long()]
        more = not torch.equal(l2, l)
        l = l2
        if not more:
            return l


class DynamicGraph:
    """Sequential dynamic graph with a vectorized batched read path.

    ``device=None`` means the card (``"cuda"``) and raises without one;
    the tests pass ``device="cpu"``."""

    read_only: Set[str] = {"connected"}

    def __init__(self, n_vertices: int, device=None):
        self.n = int(n_vertices)
        self.device = resolve_device(device)
        self.edges: Set[Tuple[int, int]] = set()
        self._labels: Optional[torch.Tensor] = None   # lazily rebuilt
        self._dirty = True

    # -- updates -------------------------------------------------------------
    def insert(self, u: int, v: int) -> bool:
        e = (min(u, v), max(u, v))
        if e in self.edges or u == v:
            return False
        self.edges.add(e)
        self._dirty = True
        return True

    def delete(self, u: int, v: int) -> bool:
        e = (min(u, v), max(u, v))
        if e not in self.edges:
            return False
        self.edges.remove(e)
        self._dirty = True
        return True

    # -- reads ---------------------------------------------------------------
    def _refresh(self) -> None:
        """Lazy-but-correct label rebuild: the dirty flag is cleared
        BEFORE building from a snapshot of the edge set, so an update that
        lands mid-rebuild re-marks it and the loop rebuilds again."""
        while self._dirty:
            self._dirty = False
            edges = list(self.edges)           # snapshot, pre-clear ordering
            arr = np.zeros((2, max(1, len(edges))), np.int32)
            if edges:                          # padding = (0,0) self-loops
                arr[:, :len(edges)] = np.asarray(edges, np.int32).T
            uv = torch.from_numpy(arr).to(self.device)
            self._labels = _components(uv[0], uv[1], self.n)

    def connected(self, u: int, v: int) -> bool:
        return self.read_batch(["connected"], [(u, v)])[0]

    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        """Answer a batch of ``connected`` queries with one gather."""
        if any(m != "connected" for m in methods):
            raise ValueError("graph reads are 'connected'")
        if not inputs:
            return []
        self._refresh()
        q = torch.from_numpy(np.asarray(inputs, np.int64).reshape(-1, 2).T
                             .copy()).to(self.device)
        return (self._labels[q[0]] == self._labels[q[1]]).cpu().tolist()

    # -- generic apply (Lock / RW-Lock / FC wrappers) --------------------------
    def apply(self, method: str, input: Any = None) -> Any:
        if method == "insert":
            return self.insert(*input)
        if method == "delete":
            return self.delete(*input)
        if method == "connected":
            return self.connected(*input)
        raise ValueError(f"unknown method {method!r}")
