"""Phase 4, the collective insert: the hand-written CUDA kernel
(``csrc/heap_insert.cu``, which runs the whole level-chunk loop in one
launch) and its plain PyTorch versions.

The wrappers pick their path from the heap's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs :func:`phase4_plain`.
Both update the heap in place.  ``phase4_sharded.launches`` counts kernel
launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .._common import INF, depth, gather_masked, put, take

MAX_C = 64          # the (C, C) InsertSet is double-buffered in shared memory


def chunk_len(size: torch.Tensor, left: torch.Tensor) -> torch.Tensor:
    """Length of the next level-chunk (``batched_pq._chunk_len``): targets
    ``size+1 ..`` truncated at the last id on that tree level."""
    lo = size + 1
    d = depth(lo).to(lo.dtype)
    level_end = torch.bitwise_left_shift(torch.full_like(lo, 2), d) - 1
    return torch.minimum(left, level_end - lo + 1)


def _tcount(v: torch.Tensor, d: int, d_c: torch.Tensor, lo_c: torch.Tensor,
            hi_c: torch.Tensor) -> torch.Tensor:
    """#targets in subtree(v) for v at depth d (targets on one level d_c)."""
    shift = torch.clamp(d_c - d, min=0)
    vlo = v << shift
    vhi = vlo + torch.bitwise_left_shift(torch.ones_like(shift), shift) - 1
    cnt = torch.clamp(torch.minimum(hi_c, vhi) - torch.maximum(lo_c, vlo) + 1,
                      min=0)
    return torch.where(v > 0, cnt, 0)


def replace_head_sorted(S: torch.Tensor, x: torch.Tensor,
                        do: torch.Tensor) -> torch.Tensor:
    """Per row of S (..., C): drop S[0], insert x, keep the row sorted
    (+inf padded) where ``do`` (``batched_pq._replace_head_sorted``)."""
    C = S.shape[-1]
    lane = torch.arange(C, device=S.device)
    shifted = torch.cat([S[..., 1:], torch.full_like(S[..., :1], INF)], -1)
    k = (shifted <= x[..., None]).sum(-1, keepdim=True)
    src = torch.where(lane < k, lane, torch.clamp(lane - 1, min=0))
    merged = torch.where(lane == k, x[..., None], shifted.gather(-1, src))
    return torch.where(do[..., None], merged, S)


def insert_chunk_plain(a: torch.Tensor, size: torch.Tensor,
                       chunk_vals: torch.Tensor,
                       m_chunk: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Torch port of ``batched_pq._insert_chunk`` over a shard axis.

    a: (K, cap) f32, updated in place; size/m_chunk: (K,) int;
    chunk_vals: (K, C) sorted ascending, +inf padded.  Per shard, places
    the m_k values at slots size_k+1 .. size_k+m_k, which must lie on one
    tree level.  Returns (a, size + m).  The level loop stops after the
    deepest target level, read on the host (CPU path and yardstick only).
    """
    K, C = chunk_vals.shape
    dev = a.device
    lane = torch.arange(C, device=dev, dtype=torch.int64)
    size = size.long()
    m_chunk = m_chunk.long()
    lo_c = (size + 1)[:, None]
    hi_c = (size + m_chunk)[:, None]
    d_c = depth(lo_c).long()
    nonempty = (m_chunk > 0)[:, None]
    S0 = torch.where((lane < m_chunk[:, None]) & nonempty, chunk_vals, INF)
    sets = torch.full((K, C, C), INF, dtype=torch.float32, device=dev)
    sets[:, 0] = S0
    n_levels = int(torch.where(nonempty, d_c, -1).max()) + 1
    for d in range(n_levels):
        live = nonempty & (d <= d_c)                              # (K, 1)
        lo_d = lo_c >> torch.clamp(d_c - d, min=0)
        hi_d = hi_c >> torch.clamp(d_c - d, min=0)
        v = lo_d + lane                                           # (K, C)
        slot_on = live & (v <= hi_d)
        is_leaf = d == d_c

        minS = sets[..., 0]
        av = take(a, torch.where(slot_on, v, 0))
        do_swap = slot_on & ~is_leaf & (minS < av)
        place = torch.where(do_swap | (slot_on & is_leaf), minS, av)
        put(a, torch.where(slot_on & (do_swap | is_leaf), v, 0), place)
        sets = replace_head_sorted(sets, av, do_swap)

        # prefix split of each sorted row by the left child's target count
        lc = _tcount(2 * v, d + 1, d_c, lo_c, hi_c)[..., None]    # (K, C, 1)
        split_on = slot_on & ~is_leaf
        left = torch.where(lane < lc, sets, INF)
        right = torch.where(lane + lc < C,
                            sets.gather(-1, torch.clamp(lane + lc, 0, C - 1)),
                            INF)
        lo_next = lo_c >> torch.clamp(d_c - (d + 1), min=0)
        hi_next = hi_c >> torch.clamp(d_c - (d + 1), min=0)
        lraw = 2 * v - lo_next
        rraw = lraw + 1
        ok_l = split_on & (lraw >= 0) & (lraw <= hi_next - lo_next)
        ok_r = split_on & (rraw >= 0) & (rraw <= hi_next - lo_next)
        # child rows are unique per node; the rest go to dump row C
        nxt = torch.full((K, C + 1, C), INF, dtype=torch.float32, device=dev)
        for ok, raw, half in ((ok_l, lraw, left), (ok_r, rraw, right)):
            slot = torch.where(ok, raw, C)[..., None].expand(K, C, C)
            nxt.scatter_(1, slot, torch.where(ok[..., None], half, INF))
        sets = torch.where((live & ~is_leaf)[..., None], nxt[:, :C], sets)
    new_size = size + torch.where(nonempty[:, 0], m_chunk, 0)
    return a, new_size.to(torch.int32)


def phase4_plain(a: torch.Tensor, size: torch.Tensor, rem: torch.Tensor,
                 m_left: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch port of ``batched_pq._phase4`` (and ``sharded_pq.py``'s
    K-vector chunk loop): the remaining sorted inserts ``rem`` (K, C),
    ``m_left`` (K,) of them per shard, placed in level-chunks by
    :func:`insert_chunk_plain`.  Returns (a, new size)."""
    C = rem.shape[-1]
    lane = torch.arange(C, device=a.device)
    size = size.to(torch.int32)
    off = torch.zeros_like(size)
    left = m_left.to(torch.int32)
    while bool((left > 0).any()):
        m = chunk_len(size, left)
        vals = gather_masked(rem, off[:, None] + lane, lane < m[:, None])
        a, size = insert_chunk_plain(a, size, vals, m)
        off = off + m
        left = left - m
    return a, size


def phase4_sharded(a: torch.Tensor, size: torch.Tensor, rem: torch.Tensor,
                   m_left: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """All-shards phase 4, one CTA per shard on the card and one launch
    for the whole level-chunk loop.

    a: (K, cap) f32 heap stack, updated in place; size: (K,) int32;
    rem: (K, C) f32 sorted ascending, +inf padded; m_left: (K,) int32.
    Returns (a, new size (K,) int32).
    """
    if a.device.type == "cpu":
        return phase4_plain(a, size, rem, m_left)
    K, cap = a.shape
    C = rem.shape[-1]
    if not 1 <= C <= MAX_C:
        raise ValueError(f"heap_insert supports chunk widths 1..{MAX_C}")
    _build.require(a, "a", torch.float32, (K, cap), a.device)
    _build.require(size, "size", torch.int32, (K,), a.device)
    _build.require(rem, "rem", torch.float32, (K, C), a.device)
    _build.require(m_left, "m_left", torch.int32, (K,), a.device)
    new_size = torch.empty_like(size)
    rc = _build.library().heap_insert_launch(
        a.data_ptr(), size.data_ptr(), rem.data_ptr(), m_left.data_ptr(),
        K, cap, C, new_size.data_ptr(), _build.stream(a.device))
    _build.check(rc, "heap_insert")
    phase4_sharded.launches += 1
    return a, new_size


phase4_sharded.launches = 0


def phase4(a: torch.Tensor, size: torch.Tensor, rem: torch.Tensor,
           m_left: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-heap form: a (cap,), size/m_left () int32, rem (C,)."""
    _, new_size = phase4_sharded(a[None], size.reshape(1), rem[None],
                                 m_left.reshape(1))
    return a, new_size[0]


def insert_chunk(a: torch.Tensor, size: torch.Tensor,
                 chunk_vals: torch.Tensor,
                 m_chunk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level-chunk on a single heap (``batched_pq._insert_chunk``'s
    contract: all targets on one level).  A single chunk is phase 4 with
    ``rem = chunk_vals``, so it takes the same kernel."""
    return phase4(a, size, chunk_vals, m_chunk)
