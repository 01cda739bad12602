"""Oracles for the label-propagation kernel (a copy of the reference's
``kernels/label_prop/ref.py``: the port keeps its own).

``label_step_reference`` is the element-wise twin of one iteration
(scatter-min hooking + pointer jump through the OLD labels) in plain numpy
— the CUDA kernel, the plain PyTorch version and this oracle must agree
bit-exactly at every iteration, not just at the fixpoint.

``components_reference`` is the semantic oracle for the fixpoint: the
component-min labeling computed by union-find.
"""
from __future__ import annotations

import numpy as np


def label_step_reference(labels: np.ndarray, eu: np.ndarray,
                         ev: np.ndarray) -> np.ndarray:
    """One scatter-min + pointer-jump iteration (numpy, order-independent)."""
    l = np.asarray(labels, np.int32)
    eu = np.asarray(eu, np.int64)
    ev = np.asarray(ev, np.int64)
    m = np.minimum(l[eu], l[ev])
    s = l.copy()
    np.minimum.at(s, eu, m)
    np.minimum.at(s, ev, m)
    return np.minimum(s, l[s]).astype(np.int32)


def components_reference(n: int, edges) -> np.ndarray:
    """Component-min labels via union-find (the fixpoint's semantics)."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (u, v) in edges:
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            if ru > rv:
                ru, rv = rv, ru
            parent[rv] = ru
    # component min == min root reachable; normalize roots to the min id
    mins: dict = {}
    for x in range(n):
        r = find(x)
        mins[r] = min(mins.get(r, x), x)
    return np.asarray([mins[find(x)] for x in range(n)], np.int32)
