"""Phase 1, the frontier search: the hand-written CUDA kernel
(``csrc/heap_kmin.cu``: one warp a shard, the children of the taken nodes
read from an on-chip cache of the heap's top levels and of the subtrees
loaded on misses, so a launch makes 1 + misses round trips to memory) and
its plain PyTorch version.

The wrappers pick their path from the heap's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs :func:`k_smallest_plain`.
``k_smallest_sharded.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .._common import INF, gather_masked

MAX_C = 64          # the kernel keeps the 2*c_max+1 frontier in registers
                    # (at most five slots a lane) and one cached block a step


def k_smallest_plain(a: torch.Tensor, size: torch.Tensor, n_extract: int,
                     c_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch port of ``batched_pq._k_smallest`` over a shard axis.

    a: (K, cap) f32; size: (K,) int32; n_extract: the batch's extract
    count.  Returns (ids (K, c_max) int32, vals (K, c_max) f32): each
    shard's ``min(n_extract, size_k)`` smallest nodes, ascending, padded
    with (0, +inf).  The argmin takes the first minimum, as ``jnp.argmin``.
    """
    K = a.shape[0]
    dev = a.device
    F = 2 * c_max + 1
    lanes = torch.arange(F, device=dev)
    f_ids = torch.zeros((K, F), dtype=torch.int32, device=dev)
    f_ids[:, 0] = 1
    f_vals = torch.full((K, F), INF, dtype=torch.float32, device=dev)
    f_vals[:, 0] = torch.where(size >= 1, a[:, 1], INF)
    nfree = torch.ones((K, 1), dtype=torch.int64, device=dev)
    ids = torch.zeros((K, c_max), dtype=torch.int32, device=dev)
    vals = torch.full((K, c_max), INF, dtype=torch.float32, device=dev)
    sz = size[:, None]
    for i in range(c_max):
        best = f_vals.min(dim=1, keepdim=True).values
        j = torch.where(f_vals == best, lanes, F).min(dim=1,
                                                      keepdim=True).values
        v = f_ids.gather(1, j)
        active = torch.isfinite(best) & (i < n_extract)
        left, right = 2 * v, 2 * v + 1
        lval = gather_masked(a, left, active & (left <= sz))
        rval = gather_masked(a, right, active & (right <= sz))
        f_ids.scatter_(1, j, torch.where(active, left, v))
        f_vals.scatter_(1, j, torch.where(active, lval, best))
        slot = torch.where(active, nfree, F - 1)
        f_ids.scatter_(1, slot, torch.where(active, right,
                                            f_ids.gather(1, slot)))
        f_vals.scatter_(1, slot, torch.where(active, rval,
                                             f_vals.gather(1, slot)))
        nfree = nfree + active.long()
        ids[:, i] = torch.where(active, v, 0)[:, 0]
        vals[:, i] = torch.where(active, best, INF)[:, 0]
    return ids, vals


def k_smallest_sharded(a: torch.Tensor, size: torch.Tensor, n_extract: int,
                       *, c_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard frontier search, one warp per shard on the card.

    a: (K, cap) f32 heap stack; size: (K,) int32; n_extract: host int
    (the combined batch's global extract count).  Returns (ids (K, c_max)
    int32, vals (K, c_max) f32), ascending per shard, (0, +inf)-padded.
    """
    n_extract = int(n_extract)
    if a.device.type == "cpu":
        return k_smallest_plain(a, size, n_extract, c_max)
    K, cap = a.shape
    if not 1 <= c_max <= MAX_C:
        raise ValueError(f"heap_kmin supports 1 <= c_max <= {MAX_C}")
    if cap < 2:
        raise ValueError("heap capacity must be >= 2 (slot 0 is scratch)")
    _build.require(a, "a", torch.float32, (K, cap), a.device)
    _build.require(size, "size", torch.int32, (K,), a.device)
    ids = torch.empty((K, c_max), dtype=torch.int32, device=a.device)
    vals = torch.empty((K, c_max), dtype=torch.float32, device=a.device)
    rc = _build.library().heap_kmin_launch(
        a.data_ptr(), size.data_ptr(), K, cap, n_extract, c_max,
        ids.data_ptr(), vals.data_ptr(), _build.stream(a.device))
    _build.check(rc, "heap_kmin")
    k_smallest_sharded.launches += 1
    return ids, vals


k_smallest_sharded.launches = 0


def k_smallest(a: torch.Tensor, size: torch.Tensor, n_extract: int, *,
               c_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-heap form: a (cap,), size () int32 -> (ids (c_max,),
    vals (c_max,)); the K = 1 launch of :func:`k_smallest_sharded`."""
    ids, vals = k_smallest_sharded(a[None], size.reshape(1), n_extract,
                                   c_max=c_max)
    return ids[0], vals[0]


__all__ = ["k_smallest", "k_smallest_sharded", "k_smallest_plain"]
