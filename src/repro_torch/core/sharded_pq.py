"""Sharded batched priority queue (DESIGN.md §9–§10) — K heaps, one pass.

The port of ``repro.core.sharded_pq``: K independent 1-indexed heaps live
as rows of one ``(K, capacity)`` tensor, and one combined batch runs over
all of them as one pass:

1. **route** — inserts go to shards by a bit-mix hash of their key
   (default) or by a fixed key range (``key_range=``), on the device;
2. **frontier merge** — every shard's ``min(|E|, size_k)`` smallest nodes
   come from one ``heap_kmin`` launch (one CTA per shard) and the K
   candidate lists are merged by one stable global sort; the first
   ``|E|`` finite entries decide the per-shard extract counts ``e_k``;
3. **batch-apply** — phases 2–4 of the §4 algorithm run on all K shards
   at once (``heap_sift`` and ``heap_insert``, one CTA per shard each);
4. **answer merge** — the K per-shard extract lists are merged by one
   sort; the first ``k_eff = min(|E|, Σ size_k)`` values are the answer.

The pass updates the heap stack in place (the reference donates it), and
on a CPU heap the kernel wrappers run their plain versions.

Correctness: the global |E| smallest keys of the union are a subset of the
union of per-shard |E|-smallest candidate lists, so step 2's merge picks
exactly the right multiset; step 3 then extracts precisely those nodes
because each shard's frontier search is deterministic.

Placement (DESIGN.md §18): under a ``MeshPlacement`` each rank holds only
its ``K / D`` rows, the kernels run on them, and the two K-way merges
become collectives — an all-gather of the ``(K / D, c_max)`` frontier
candidates (mesh order is stacked order, so the global merge, the
``chosen`` mask and the extract counts are the stacked pass's bit for
bit), an all-gather of the extract rows for the answer, and an
all-reduce of the sizes for ``k_eff``.  Routing, the occupancy mirror and
the merges run replicated on every rank.  The passes take the
placement's collectives as ``comm``; the stacked ones are identities, so
the stacked pass is unchanged.  Every public call that reaches the rows
runs through the mesh's dispatch channel (``core.placement.led``), so a
threaded combiner on the leader rank drives the followers' rows too.
"""
from __future__ import annotations

import heapq
from typing import Any, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..kernels.heap_kmin import k_smallest_sharded
from . import batched_pq as _bpq
from . import substrate
from .faults import make_guard
from .placement import REBUILD, STACKED, led, placed_device, resolve_placement
from .batched_pq import (
    INF,
    _TINY,
    KERNEL_PHASES,
    AsyncBatchResult,
    Phases,
    RoundResult,
    _RoundsFetch,
    _flush_subnormals,
    _phases12,
    apply_sliced_async,
    expand_rounds,
    require_finite_keys,
    resolve_device,
)


def host_key(x: float) -> float:
    """Quantize a host float to the exact f32 key the device heap stores.

    Applies f32 rounding, the entry flush-to-zero (DESIGN.md §7) and a
    clamp to the finite f32 range (±inf is the heap's empty-slot
    sentinel), so a key extracted from the device round-trips exactly to
    the host-side value produced here.
    """
    k = np.float32(x)
    if np.isnan(k):
        raise ValueError("key must not be NaN")
    if not np.isfinite(k):
        big = np.finfo(np.float32).max
        k = np.float32(big) if k > 0 else np.float32(-big)
    if abs(k) < _TINY:
        k = np.float32(0.0)
    return float(k)


def host_keys(xs) -> np.ndarray:
    """:func:`host_key` over an array: the f32 keys the device heap
    stores, as one numpy pass."""
    k = np.asarray(xs, np.float32)
    if np.isnan(k).any():
        raise ValueError("key must not be NaN")
    big = np.finfo(np.float32).max
    return _flush_host(np.clip(k, -big, big))


class ShardedHeapState(NamedTuple):
    """K 1-indexed array heaps stacked on the leading axis."""

    a: torch.Tensor      # (K, capacity) float32, +inf marks empty slots
    size: torch.Tensor   # (K,) int32


def state_from_numpy(a, size, device=None) -> ShardedHeapState:
    """A port heap stack from numpy (e.g. a fetched reference state)."""
    dev = resolve_device(device)
    return ShardedHeapState(
        torch.tensor(np.asarray(a, np.float32), device=dev),
        torch.tensor(np.asarray(size, np.int32), device=dev))


def to_numpy(state: ShardedHeapState) -> Tuple[np.ndarray, np.ndarray]:
    """``(a (K, cap), size (K,))`` of a port heap stack (one fetch)."""
    a, size = _bpq._host_fetch((state.a, state.size))
    return np.asarray(a), np.asarray(size)


# ---------------------------------------------------------------------------
# Insert routing — hash (default) or key-range (Lim-style partition).
# Each rule has a bit-exact numpy twin so the host wrapper can mirror the
# device's shard assignment WITHOUT a device round-trip (the overflow guard
# below runs sync-free, DESIGN.md §10).
# ---------------------------------------------------------------------------
_MASK32 = 0xFFFFFFFF
_GOLDEN = 2654435761


def route_hash(vals: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard id per value via a Fibonacci bit-mix of the f32 bit pattern.

    uint32 arithmetic on int64: the multiply is split at 16 bits so no
    product leaves the int64 range, then wrapped to 32 bits."""
    bits = vals.to(torch.float32).view(torch.int32).to(torch.int64) & _MASK32
    lo = bits * (_GOLDEN & 0xFFFF)
    hi = ((bits * (_GOLDEN >> 16)) & 0xFFFF) << 16
    h = (lo + hi) & _MASK32
    h = h ^ (h >> 16)
    return (h % n_shards).to(torch.int32)


def route_range(vals: torch.Tensor, n_shards: int,
                lo: float, hi: float) -> torch.Tensor:
    """Shard id per value by equal-width key range over [lo, hi), in f32;
    clipped in float space before the int cast, like the numpy twin."""
    span = max(hi - lo, 1e-30)
    idx = torch.floor((vals - lo) / span * n_shards)
    return torch.clamp(idx, 0, n_shards - 1).to(torch.int32)


def _route(vals: torch.Tensor, n_shards: int,
           key_range: Optional[Tuple[float, float]]) -> torch.Tensor:
    if key_range is None:
        return route_hash(vals, n_shards)
    return route_range(vals, n_shards, key_range[0], key_range[1])


def _flush_host(vals) -> np.ndarray:
    v = np.asarray(vals, np.float32)
    return np.where(np.abs(v) < _TINY, np.float32(0.0), v)


def route_hash_host(vals, n_shards: int) -> np.ndarray:
    """Numpy twin of :func:`route_hash` (bit-exact: uint32 wrap-around)."""
    bits = _flush_host(vals).view(np.uint32)
    with np.errstate(over="ignore"):
        h = bits * np.uint32(_GOLDEN)
    h = h ^ (h >> np.uint32(16))
    return (h % np.uint32(n_shards)).astype(np.int32)


def route_range_host(vals, n_shards: int, lo: float, hi: float) -> np.ndarray:
    """Numpy twin of :func:`route_range` (same f32 arithmetic)."""
    span = np.float32(max(hi - lo, 1e-30))
    v = _flush_host(vals)
    idx = np.floor((v - np.float32(lo)) / span * np.float32(n_shards))
    return np.clip(idx, 0, n_shards - 1).astype(np.int32)


def _route_host(vals, n_shards: int,
                key_range: Optional[Tuple[float, float]]) -> np.ndarray:
    if key_range is None:
        return route_hash_host(vals, n_shards)
    return route_range_host(vals, n_shards, key_range[0], key_range[1])


# ---------------------------------------------------------------------------
# One packed row over all K shards: a combined batch or a peek
# ---------------------------------------------------------------------------
MEGA_UPDATE, MEGA_READ = 0, 1


def _sharded_apply_batch(
    state: ShardedHeapState, row: torch.Tensor,
    *, c_max: int, n_shards: int,
    key_range: Optional[Tuple[float, float]] = None,
    phases: Phases = KERNEL_PHASES, n_pull: Optional[int] = None,
    comm=STACKED,
) -> Tuple[ShardedHeapState, torch.Tensor, torch.Tensor]:
    """Apply one packed row (:func:`batched_pq.pack_rows`), updating
    ``state`` in place.

    ``row``: (3 + c_max,) int32 on the heap's device: a tag, the extract
    and insert counts (≤ c_max are used) and the insert values, all read
    on the device.  A ``MEGA_UPDATE`` row is one combined batch of ≤ c_max
    extracts + ≤ c_max inserts; a ``MEGA_READ`` row is ``peek_min``'s
    frontier merge (:func:`_peek_min_impl`, its extract count the peek
    width): its per-shard extract and insert counts are multiplied by
    ``tag == MEGA_UPDATE`` on the device, so the phases leave ``a`` and
    ``size`` bit-identical, and its answer is the frontier instead of the
    extracted keys — the port's form of the reference's ``lax.cond``.
    Returns (state, answer (c_max,) ascending +inf-padded, k_eff) where
    k_eff = min(ne, Σ size_k).  One launch of each kernel on a CUDA heap;
    nothing is read on the host, so a CUDA graph can capture the pass.

    ``n_pull``: a host bound on the tail pulls; the eager single pass
    knows its extract count and passes it, every pass whose counts stay
    on the device runs the static c_max (None), whose extra steps are
    masked no-ops.  ``phases`` is the yardstick seam: no entry point
    passes it, and only ``chip_smoke.py`` swaps in
    :data:`batched_pq.PLAIN_PHASES` (or checked phases) to hold the
    kernel pass against the plain pass on the card.

    ``comm``: the placement's collectives (``core.placement``).  Under a
    mesh, ``state`` holds this rank's ``K / D`` rows (global shards
    ``base …``): inserts route against global shard ids and keep the
    local ones, the frontier candidates and the extract rows are
    all-gathered into the stacked (K, c_max) order, and the sizes are
    all-reduced for ``k_eff``.
    """
    K = n_shards
    a, size = state
    dev = a.device
    K_local = a.shape[0]
    base = comm.index * K_local
    lane = torch.arange(c_max, device=dev, dtype=torch.int32)
    tag, ne, ni, insert_vals = _bpq.row_fields(row, c_max)
    update = tag == MEGA_UPDATE
    insert_vals = _flush_subnormals(insert_vals)
    ins_valid = (lane < ni) & update

    # -- 1. route inserts to shards (invalid lanes park on shard 0 masked out)
    shard_of = torch.where(ins_valid, _route(insert_vals, K, key_range), 0)
    shard_ids = torch.arange(K, device=dev, dtype=torch.int32)
    local_ids = shard_ids[base:base + K_local]
    one_hot = (shard_of[None, :] == local_ids[:, None]) & ins_valid[None, :]
    ins_rows = torch.sort(torch.where(one_hot, insert_vals[None, :], INF),
                          dim=1).values
    ins_counts = one_hot.sum(dim=1, dtype=torch.int32)

    # -- 2. per-shard frontier candidates (read-only) + global merge
    cand_ids, cand_vals = phases.kmin(a, size, ne, c_max=c_max)
    flat_vals = comm.gather(cand_vals).reshape(-1)       # (K*c_max,)
    flat_shard = shard_ids[:, None].expand(K, c_max).reshape(-1).long()
    order = torch.argsort(flat_vals, stable=True)
    flat_sorted = flat_vals[order]
    chosen = ((torch.arange(K * c_max, device=dev) < ne)
              & torch.isfinite(flat_sorted) & update)
    # segment sum by scatter_add_ (bincount would sync on CUDA)
    e_counts = torch.zeros(K, dtype=torch.int32, device=dev).scatter_add_(
        0, flat_shard[order], chosen.to(torch.int32))

    # -- 3. phases 1–2 on every shard.  The frontier scan is deterministic
    # and prefix-stable, so the first e_k lanes of the step-2 candidates
    # ARE shard k's phase-1 result — mask and reuse them.
    e_local = e_counts[base:base + K_local]
    take_k = lane < e_local[:, None]
    phase1 = (torch.where(take_k, cand_ids, 0),
              torch.where(take_k, cand_vals, INF))
    k_eff = torch.minimum(comm.sum(size.sum()),
                          ne.to(torch.int64)).to(torch.int32)
    a2, size2, out_rows, _k_eff_k, starts, active, rem, m_left = _phases12(
        a, size, e_local, ins_rows, ins_counts, c_max=c_max, phase1=phase1,
        n_pull=c_max if n_pull is None else n_pull)

    # -- 3b. sift wavefront + collective inserts on every shard
    phases.sift(a2, size2, starts, active)
    _, new_size = phases.phase4(a2, size2, rem, m_left)
    size.copy_(new_size)

    # -- 4. merge the per-shard answers (ascending, +inf padded); a read
    # row answers the frontier's ne smallest keys
    merged = torch.sort(comm.gather(out_rows).reshape(-1)).values[:c_max]
    frontier = torch.where(lane < ne, flat_sorted[:c_max], INF)
    return state, torch.where(update, merged, frontier), k_eff


def sharded_apply_batch(state, row, **kw):
    """In-place pass (the reference's donated jit)."""
    return _sharded_apply_batch(state, row, **kw)


def sharded_apply_batch_undonated(state, row, **kw):
    """Ablation twin (EXPERIMENTS §Ablations): the pass on a clone."""
    clone = ShardedHeapState(state.a.clone(), state.size.clone())
    return _sharded_apply_batch(clone, row, **kw)


def _sharded_mixed_rows(
    state: ShardedHeapState, rows: torch.Tensor, *, c_max: int,
    n_shards: int, key_range: Optional[Tuple[float, float]] = None,
    phases: Phases = KERNEL_PHASES, comm=STACKED,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """R packed rows (R, 3 + c_max) int32 on the heap's device, tagged
    ``MEGA_UPDATE`` / ``MEGA_READ``, run in order and in place: the
    megapass (DESIGN.md §17; the reference's ``_sharded_mixed_impl``).
    Returns ``(outs (R, c_max), k_effs (R,))``.  Nothing here reads a
    tensor on the host (no ``int()``, ``.item()``, ``nonzero`` or
    data-dependent shape), so ``ShardedBatchedPQ`` captures it as one
    CUDA graph per R; run eagerly it is the graph's yardstick, the CPU's
    pass and a mesh's (``comm``: the placement's collectives)."""
    outs, k_effs = [], []
    for r in range(rows.shape[0]):
        _, out, k_eff = _sharded_apply_batch(
            state, rows[r], c_max=c_max, n_shards=n_shards,
            key_range=key_range, phases=phases, comm=comm)
        outs.append(out)
        k_effs.append(k_eff)
    return torch.stack(outs), torch.stack(k_effs)


def _peek_min_impl(state: ShardedHeapState, n_extract: torch.Tensor, *,
                   c_max: int, comm=STACKED
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read-only twin of :func:`_sharded_apply_batch` steps 1–2: the
    per-shard frontier candidates and the global merge, without the
    extraction phases.  ``n_extract``: () int32 on the heap's device.
    Returns ``(merged (c_max,) ascending +inf-padded, k_eff)``: the
    ``n_extract`` globally smallest keys.  Under a mesh (``comm``) the
    local candidates are all-gathered before the merge."""
    a, size = state
    ne = torch.clamp(n_extract, max=c_max)
    _ids, cand_vals = k_smallest_sharded(a, size, ne, c_max=c_max)
    flat = torch.sort(comm.gather(cand_vals).reshape(-1)).values[:c_max]
    lane = torch.arange(c_max, device=a.device)
    merged = torch.where(lane < ne, flat, INF)
    k_eff = torch.minimum(comm.sum(size.sum()),
                          ne.to(torch.int64)).to(torch.int32)
    return merged, k_eff


def pad_rows(specs, c_max: int) -> list:
    """``specs`` padded to the next power of two with no-op read rows (ne
    = 0: pure, so padding never perturbs the serial schedule) — what
    bounds the captured graphs at one a power of two."""
    pad = np.full((c_max,), np.inf, np.float32)
    n_rows = 1 << (len(specs) - 1).bit_length()
    return list(specs) + [(MEGA_READ, 0, pad, 0)] * (n_rows - len(specs))


class _RowsGraph(NamedTuple):
    """One captured replay of :func:`_sharded_mixed_rows` at R rows."""

    graph: Any                   # torch.cuda.CUDAGraph
    rows: torch.Tensor           # its static (R, 3 + c_max) int32 input
    outs: torch.Tensor           # its (R, c_max) output, cloned each replay
    launches: Tuple[Tuple[Any, int], ...]   # (kernel wrapper, launches)


# ---------------------------------------------------------------------------
# Host-facing wrapper (same interface as BatchedPriorityQueue)
# ---------------------------------------------------------------------------
class _PQBatchHandle:
    """Protocol-shaped view of an :class:`AsyncBatchResult`: per-op
    results in arrival order — ``extract_min`` ops get the batch's
    ascending extracted values (None-padded past the live size, matching
    the oracle's pop order), ``insert`` ops get None."""

    def __init__(self, batch_handle: Optional[AsyncBatchResult],
                 methods: List[str]):
        self._h = batch_handle
        self._methods = methods

    def result(self) -> List[Any]:
        vals = self._h.result() if self._h is not None else []
        out: List[Any] = []
        j = 0
        for m in self._methods:
            if m == "extract_min":
                out.append(vals[j] if j < len(vals) else None)
                j += 1
            else:
                out.append(None)
        return out


class _PQPeekRound:
    """Handle for one ``peek_min`` read round of a megapass: every op in
    the round observes the same linearization point, so each answers THE
    global minimum at that point (None when empty).  Resolution shares
    the dispatch's one :class:`_RoundsFetch` transfer."""

    def __init__(self, shared: Optional[_RoundsFetch], row_id: int,
                 n_ops: int):
        self._shared = shared
        self._row = row_id
        self._n = n_ops

    def result(self) -> List[Any]:
        if not self._n:
            return []
        v = float(self._shared.rows()[self._row][0])
        return [v if np.isfinite(v) else None] * self._n


class ShardedBatchedPQ(substrate.BatchedStructure):
    """K-sharded device-resident PQ with combined batch application.

    Args:
      capacity: per-shard heap capacity (slot 0 is scratch, as in §4).
      c_max: combined-batch capacity per pass.
      n_shards: number of independent heap shards (K).
      values: optional initial values, routed with the same rule as inserts.
      key_range: optional (lo, hi) — route by key range instead of hash.
      donate: update the heap stack in place (zero-copy pass, default);
        False is the clone-per-pass ablation twin.
      fault_plan: optional :class:`~repro_torch.core.faults.FaultPlan`
        whose ``maybe_fail_dispatch`` probe fires after every pass.
      guard: transactional dispatch (DESIGN.md §15) — a ready
        ``DispatchGuard``, ``True`` (guard without a plan), or ``None``
        (guard exactly when a plan is given).  Guarded passes snapshot the
        heap stack + occupancy mirror and restore bit-identically on
        failure.
      placement: shard layout (DESIGN.md §18) — ``None`` /
        ``StackedPlacement`` keeps all K rows in this process; a
        ``MeshPlacement`` (K % D == 0) keeps this rank's K / D rows on its
        device and runs the passes' merges as collectives over a process
        group of the structure's own.  Every rank of the mesh builds the
        same queue; then either every rank makes the same calls (SPMD),
        or the leader (mesh index 0) alone makes them and the other ranks
        :meth:`follow` — each call is sent on the placement's dispatch
        channel before it runs, and a guarded dispatch's outcome after
        (``core.placement``).  The occupancy mirror, snapshots and
        restores work on each rank's rows as they do stacked, and a
        rounds dispatch runs its rows eagerly (no CUDA graph captures a
        collective).  Anything else raises ``TypeError``.
      comm: the placement's collectives to run on — a queue that
        replaces another on the same placement passes the old one's
        :attr:`comm`, so no communicator is started again, and the
        followers of the old queue rebuild theirs (:meth:`rebuilt`);
        ``None`` takes a process group of the queue's own.
      device: ``None`` means the card (``"cuda"``) and raises without
        one; the tests pass ``"cpu"``.  Under a mesh, the rank's device.

    Sync-free occupancy guard (DESIGN.md §10): the wrapper mirrors the
    device's insert routing on the host (bit-exact numpy twins) and keeps
    per-shard occupancy *upper bounds* plus the *exact* total size, so the
    per-slice overflow check never reads a device value.  Same-slice
    extracts are credited with the guaranteed lower bound
    ``e_k ≥ min(ne, total) - Σ_{j≠k} size_j``.  The bounds re-tighten to
    the true sizes at every consumed ``result()``.  The wrapper is not
    thread-safe; confine each instance to one thread (the combiner).
    :meth:`global_state` gives the global (K, …) heap stack whatever the
    placement (a collective under a mesh).

    Rounds dispatches (:meth:`apply_rounds_async`, :meth:`mixed_rounds`)
    lower onto packed device rows (:func:`_sharded_mixed_rows`), padded to
    the next power of two with no-op read rows.  On a donated, stacked
    CUDA heap such a dispatch is ONE replay of a CUDA graph captured at the
    first dispatch of its row count (the pow2 padding bounds the captured
    graphs at one per power of two, as it bounds the reference's jit
    cache): the rows go to the device in one copy, into the graph's static
    input, and the answers are cloned out of its static output after the
    replay, so a later replay cannot overwrite an unconsumed handle.  The graph binds
    the live ``a`` and ``size``: a restore copies into them, and rebinding
    :attr:`state` to other tensors drops the cache.  ``donate=False``
    clones the heap every dispatch and stays eager, as the reference's
    undonated twin is a separate jit.  ``graph_captures`` and
    ``graph_replays`` count the graphs; each replay adds the kernel
    launches its graph captured to the wrappers' ``launches`` counters.
    """

    structure = "pq"
    read_only: Set[str] = {"values", "peek_min"}
    supports_megapass = True
    supports_placement = True

    def __init__(self, capacity: int, c_max: int, n_shards: int = 4,
                 values=None, key_range: Optional[Tuple[float, float]] = None,
                 donate: bool = True, fault_plan=None, guard=None,
                 placement=None, comm=None, device=None):
        if c_max < 1:
            raise ValueError("c_max must be >= 1")
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (slot 0 is scratch)")
        self.c_max = int(c_max)
        self.capacity = int(capacity)
        self.n_shards = int(n_shards)
        self.donate = bool(donate)
        self.placement = resolve_placement(placement)
        self.placement.validate(self.n_shards)
        self.device = placed_device(self.placement, device)
        self.key_range = (
            (float(key_range[0]), float(key_range[1]))
            if key_range is not None else None)
        self.fault_plan = fault_plan
        self._guard = make_guard(fault_plan, guard)
        self.graph_captures = 0
        self.graph_replays = 0
        self._graphs = {}
        self._comm = comm if comm is not None else self.placement.comm()
        rebuild = dict(capacity=capacity, c_max=c_max, n_shards=n_shards,
                       values=values, key_range=key_range, donate=donate)
        if comm is not None and comm.channel is not None:
            with comm.channel.record(REBUILD, (), rebuild):
                self.state = self._init_state(values)
        else:
            self.state = self._init_state(values)

    def rebuilt(self, **kw) -> "ShardedBatchedPQ":
        """A follower's replay of the leader's rebuild: a fresh queue of
        the leader's arguments ``kw`` on this queue's comm, guard,
        placement and device."""
        return ShardedBatchedPQ(fault_plan=self.fault_plan, guard=self._guard,
                                placement=self.placement, comm=self._comm,
                                device=self.device, **kw)

    @property
    def comm(self):
        """The placement's collectives this queue runs on (its process
        group under a mesh, the identities when stacked)."""
        return self._comm

    @property
    def state(self) -> ShardedHeapState:
        return self._state

    @state.setter
    def state(self, st: ShardedHeapState) -> None:
        # the captured graphs bind the live buffers: other tensors, no graphs
        old = self.__dict__.get("_state")
        if old is None or st.a is not old.a or st.size is not old.size:
            self._graphs = {}
        self._state = st

    def _init_state(self, values) -> ShardedHeapState:
        K, cap = self.n_shards, self.capacity
        a = np.full((K, cap), np.inf, np.float32)
        size = np.zeros((K,), np.int32)
        values = list(values) if values is not None else []
        if values:
            require_finite_keys(values)
            vals = _flush_host(values)
            shards = _route_host(vals, K, self.key_range)
            for k in range(K):
                mine = np.sort(vals[shards == k])
                if mine.size + 1 > cap:
                    raise ValueError("per-shard capacity too small")
                # a sorted array satisfies the heap property
                a[k, 1:mine.size + 1] = mine
                size[k] = mine.size
        # host occupancy mirror: exact at init, upper bounds between syncs
        self._sizes_ub = size.astype(np.int64).copy()
        self._total = int(size.sum())
        a, size = self.placement.put((a, size), K)   # this rank's rows
        return state_from_numpy(a, size, self.device)

    @led
    def global_state(self) -> ShardedHeapState:
        """The (K, capacity) heap stack and (K,) sizes: the live state when
        stacked, an all-gather of every rank's rows under a mesh (every
        rank calls it)."""
        return self.placement.gather(self.state, self._comm)

    @led
    def __len__(self) -> int:
        return int(self._comm.sum(self.state.size.sum()))

    @property
    def _pass_kw(self):
        return dict(c_max=self.c_max, n_shards=self.n_shards,
                    key_range=self.key_range, comm=self._comm)

    def _refresh_sizes(self, sizes) -> None:
        """Replace the occupancy mirror with fetched true sizes (read at
        consumption time, so they match the slices already accounted)."""
        self._sizes_ub = np.asarray(sizes, np.int64).copy()
        self._total = int(self._sizes_ub.sum())

    def _guard_and_account(self, ne: int, buf: np.ndarray, ni: int) -> None:
        """Sync-free per-slice overflow guard + host mirror update."""
        K = self.n_shards
        growth = np.zeros((K,), np.int64)
        if ni:
            shards = _route_host(buf[:ni], K, self.key_range)
            growth = np.bincount(shards, minlength=K).astype(np.int64)
        ub = self._sizes_ub
        # guaranteed same-slice extract credit per shard: the min(ne, total)
        # globally smallest keys exist somewhere; at most Σ_{j≠k} size_j of
        # them live outside shard k.  size_k ≥ total - Σ_{j≠k} ub_j.
        take = min(ne, self._total)
        lb = np.maximum(self._total - (ub.sum() - ub), 0)
        credit = np.maximum(take - (self._total - lb), 0)
        peak = ub - credit + growth
        if np.any(peak + 1 > self.capacity):
            # routing skew could overflow one shard while the queue as a
            # whole has room — refuse rather than let a pass drop keys
            raise ValueError(
                f"per-shard capacity {self.capacity} exceeded: "
                f"insert routing would grow a shard past it")
        self._sizes_ub = peak
        self._total = self._total + int(growth.sum()) - take

    # -- transactional dispatch (DESIGN.md §15) --------------------------
    def _snapshot(self):
        """Device-side copies (the pass mutates the live buffers in
        place, so a restore needs its own) + the host mirror."""
        st = ShardedHeapState(self.state.a.clone(), self.state.size.clone())
        return st, self._sizes_ub.copy(), self._total

    def _restore(self, snap) -> None:
        """Write the snapshot into the live buffers (bit-identical), so
        the captured graphs, which bind them, stay valid."""
        st, self._sizes_ub, self._total = snap
        self.state.a.copy_(st.a)
        self.state.size.copy_(st.size)

    @led(send_args=False, replay="_follow_sizes")
    def _fetch_sizes(self):
        # a copy taken at consumption time: later passes mutate size in
        # place (under a mesh, all K sizes gathered from the ranks)
        return self._comm.gather(self.state.size.clone())

    def _follow_sizes(self) -> None:
        """A follower's side of the leader's consumed fetch: the same
        gather of the sizes, and the same refresh of the mirror."""
        self._refresh_sizes(self._fetch_sizes().cpu().numpy())

    def _step(self, ne, buf, ni):
        def thunk():
            # the mirror mutation lives INSIDE the guarded thunk so a
            # restore rewinds accounting and device state together
            self._guard_and_account(ne, buf, ni)
            fn = sharded_apply_batch if self.donate \
                else sharded_apply_batch_undonated
            row = torch.from_numpy(_bpq.pack_rows(
                [(MEGA_UPDATE, ne, buf, ni)], self.c_max)[0]).to(
                    self.device, non_blocking=True)
            self.state, vals, k_eff = fn(self.state, row, n_pull=ne,
                                         **self._pass_kw)
            return vals, k_eff

        if self._guard is None:
            return thunk()
        return self._guard.run(thunk, self._snapshot, self._restore,
                               site="pq.apply_batch", channel=self.channel)

    @led
    def apply_async(self, extracts: int, inserts) -> AsyncBatchResult:
        """Apply a combined batch; extracted values stay on the device
        until ``.result()`` — one blocking host sync per call, not per
        slice.  Batches larger than c_max are applied in c_max slices.

        The overflow guard is ATOMIC across slices: every slice is
        pre-validated against the host mirror before ANY slice reaches
        the device, so a refused oversized batch leaves the device
        buffers and the mirror exactly as they were."""
        inserts = list(inserts)
        require_finite_keys(inserts)
        specs, _ = expand_rounds([(extracts, inserts)], self.c_max)
        saved = (self._sizes_ub.copy(), self._total)
        try:
            for ne, buf, ni in specs:
                self._guard_and_account(ne, buf, ni)
        finally:
            self._sizes_ub, self._total = saved
        return apply_sliced_async(
            self._step, self.c_max, extracts, inserts,
            extra=self._fetch_sizes, on_fetch=self._refresh_sizes)

    @led
    def apply(self, extracts: int, inserts) -> list:
        """Apply a combined batch; returns extracted values (None-padded)."""
        return self.apply_async(extracts, inserts).result()

    # -- rounds dispatches: packed rows, one graph replay on the card -------
    def _capture(self, n_rows: int) -> _RowsGraph:
        """Capture :func:`_sharded_mixed_rows` over the live heap at
        ``n_rows`` rows.  The kernels and the library load in a warm-up
        on a clone of the heap (a warm-up runs for real, a capture does
        not); the capture runs on a side stream (a non-blocking one, which
        work on the legacy default stream does not join) in thread-local
        mode, so another thread's work on the card goes on meanwhile.
        Nothing here synchronises: no blocking copy, and the capture is
        begun directly rather than through ``torch.cuda.graph``, whose
        entry synchronises the device."""
        dev = self.device
        pad = np.full((self.c_max,), np.inf, np.float32)
        rows = torch.from_numpy(_bpq.pack_rows(
            [(MEGA_READ, 0, pad, 0)] * n_rows, self.c_max)).to(
                dev, non_blocking=True)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            warm = ShardedHeapState(self.state.a.clone(),
                                    self.state.size.clone())
            _sharded_mixed_rows(warm, rows, **self._pass_kw)
            del warm
            before = [fn.launches for fn in KERNEL_PHASES]
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs, _k = _sharded_mixed_rows(self.state, rows,
                                               **self._pass_kw)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        launches = []
        for fn, b in zip(KERNEL_PHASES, before):
            n = fn.launches - b
            fn.launches -= n            # a capture launches nothing
            launches.append((fn, n))
        self.graph_captures += 1
        return _RowsGraph(graph, rows, outs, tuple(launches))

    def _run_rows(self, specs) -> torch.Tensor:
        """Run the rows ``[(tag, ne, buf, ni)]`` in order (one copy to the
        device): one graph replay on a donated CUDA heap, else the eager
        loop (on a clone when undonated).  Returns the (R, c_max)
        answers."""
        rows = torch.from_numpy(_bpq.pack_rows(specs, self.c_max)).to(
            self.device, non_blocking=True)
        if (self.donate and self.device.type == "cuda"
                and not self.placement.is_mesh):
            g = self._graphs.get(len(specs))
            if g is None:
                g = self._graphs[len(specs)] = self._capture(len(specs))
            g.rows.copy_(rows)
            g.graph.replay()
            for fn, n in g.launches:
                fn.launches += n
            self.graph_replays += 1
            return g.outs.clone()
        st = self.state if self.donate else ShardedHeapState(
            self.state.a.clone(), self.state.size.clone())
        outs, _k = _sharded_mixed_rows(st, rows, **self._pass_kw)
        self.state = st
        return outs

    def _dispatch_rows(self, specs, site: str) -> _RoundsFetch:
        """Pad ``specs`` (:func:`pad_rows`), run the occupancy guard over
        every update row before anything is dispatched (atomic refusal),
        and dispatch them as one transaction of the ``DispatchGuard``.
        Returns the dispatch's shared fetch, which also re-tightens the
        occupancy mirror."""
        specs = pad_rows(specs, self.c_max)

        def commit():
            for tag, ne, buf, ni in specs:
                if tag == MEGA_UPDATE:
                    self._guard_and_account(ne, buf, ni)
            return self._run_rows(specs)

        if self._guard is not None:
            outs = self._guard.run(commit, self._snapshot, self._restore,
                                   site=site, channel=self.channel)
        else:
            saved = (self._sizes_ub.copy(), self._total)
            try:
                outs = commit()
            except ValueError:
                self._sizes_ub, self._total = saved
                raise
        return _RoundsFetch(outs, extra=self._fetch_sizes,
                            on_fetch=self._refresh_sizes)

    @led
    def apply_rounds_async(self, rounds) -> list:
        """Apply R sequential combined batches back to back (DESIGN.md
        §12): the rounds are lowered onto ≤ c_max update rows and
        dispatched as the megapass's rows (:meth:`_dispatch_rows`: one
        graph replay on the card), the sync-free occupancy guard run per
        row on the host first.  Returns one ``RoundResult`` per round;
        every round shares one blocking fetch, which also re-tightens the
        occupancy mirror."""
        specs, layout = expand_rounds(rounds, self.c_max)
        if not specs:
            return [RoundResult(sn, ri, None) for sn, ri in layout]
        shared = self._dispatch_rows(
            [(MEGA_UPDATE, ne, buf, ni) for ne, buf, ni in specs],
            site="pq.apply_rounds")
        return [RoundResult(sn, ri, shared) for sn, ri in layout]

    @led
    def apply_rounds(self, rounds) -> list:
        """Blocking :meth:`apply_rounds_async`: per-round answer lists."""
        return [h.result() for h in self.apply_rounds_async(rounds)]

    # -- fused mixed update+read megapass (DESIGN.md §17) --------------------
    @led
    def mixed_rounds(self, rounds):
        """R heterogeneous update/``peek_min`` rounds as ONE dispatch of
        packed rows (one graph replay on the card).  Update rounds lower
        onto :func:`expand_rounds` rows (tag ``MEGA_UPDATE``), each
        non-empty ``peek_min`` round becomes one read-only frontier-merge
        row (tag ``MEGA_READ``), and every returned handle shares the
        dispatch's one blocking fetch.  Read rounds containing ``values``
        send the whole call to the base per-round dispatch — a whole-heap
        dump cannot ride a (R, c_max) result slot."""
        rounds = [(k, list(m), list(i)) for k, m, i in rounds]
        for kind, methods, _ in rounds:
            if kind not in ("update", "read"):
                raise ValueError(f"unknown round kind {kind!r} "
                                 f"(want 'update' or 'read')")
            if kind == "read" and any(m != "peek_min" for m in methods):
                return substrate.BatchedStructure.mixed_rounds(self, rounds)
        specs, plans = self._mixed_specs(rounds)
        shared = (self._dispatch_rows(specs, site="pq.mixed_rounds")
                  if specs else None)
        return self._mixed_handles(plans, shared)

    def _mixed_specs(self, rounds):
        """Lower update / ``peek_min`` rounds onto rows ``[(tag, ne, buf,
        ni)]`` (before padding), with one plan a round for its handle."""
        specs: List[Tuple[int, int, np.ndarray, int]] = []
        plans: List[Tuple] = []
        pad = np.full((self.c_max,), np.inf, np.float32)
        for kind, methods, inputs in rounds:
            if kind == "update":
                ne = 0
                ins: List[float] = []
                for m, i in zip(methods, inputs):
                    if m == "insert":
                        ins.append(float(i))
                    elif m == "extract_min":
                        ne += 1
                    else:
                        raise ValueError(f"unknown update method {m!r}")
                sub, layout = expand_rounds([(ne, ins)], self.c_max)
                row_lo = len(specs)
                (slice_ne, row_ids), = layout
                specs.extend((MEGA_UPDATE, ne_r, buf, ni)
                             for ne_r, buf, ni in sub)
                plans.append(("update", slice_ne,
                              [row_lo + r for r in row_ids], methods))
            elif methods:
                plans.append(("read", len(specs), len(methods)))
                specs.append((MEGA_READ, 1, pad, 0))
            else:
                plans.append(("read", None, 0))
        return specs, plans

    @classmethod
    def _mixed_handles(cls, plans, shared: Optional[_RoundsFetch]):
        """One handle a round plan, every one resolved by ``shared``'s
        one fetch (None: nothing was dispatched)."""
        if shared is None:
            return [cls._empty_round_handle(p) for p in plans]
        handles: List[Any] = []
        for plan in plans:
            if plan[0] == "update":
                _, slice_ne, row_ids, methods = plan
                rr = RoundResult(slice_ne, row_ids,
                                 shared if row_ids else None)
                handles.append(_PQBatchHandle(rr, methods))
            else:
                _, row, n_ops = plan
                handles.append(_PQPeekRound(shared if n_ops else None,
                                            row if row is not None else 0,
                                            n_ops))
        return handles

    @staticmethod
    def _empty_round_handle(plan):
        if plan[0] == "update":
            return _PQBatchHandle(None, plan[3])
        return _PQPeekRound(None, 0, 0)

    @led
    def values(self) -> list:
        a, sizes = to_numpy(self.global_state())
        return np.sort(np.concatenate(
            [a[k, 1:sizes[k] + 1] for k in range(self.n_shards)])).tolist()

    # -- BatchedStructure protocol surface (DESIGN.md §16) --------------------
    @led
    def update_batch_async(self, methods: Sequence[str],
                           inputs: Sequence[Any]) -> _PQBatchHandle:
        """Protocol adapter: a mixed insert/extract_min op list becomes
        ONE combined ``apply_async(ne, inserts)`` batch (extracts see the
        pre-batch multiset, §4 semantics)."""
        ne = 0
        ins: List[float] = []
        for m, i in zip(methods, inputs):
            if m == "insert":
                ins.append(float(i))
            elif m == "extract_min":
                ne += 1
            else:
                raise ValueError(f"unknown update method {m!r}")
        if ne == 0 and not ins:
            return _PQBatchHandle(None, list(methods))
        return _PQBatchHandle(self.apply_async(ne, ins), list(methods))

    @led
    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        """Answer ``values`` / ``peek_min`` reads with ONE blocking fetch
        (late-bound through ``batched_pq._host_fetch``), which also
        re-tightens the occupancy mirror.  A read list of ``peek_min``
        only fetches the frontier merge (:func:`_peek_min_impl`) instead
        of the whole heap stack."""
        for m in methods:
            if m not in ("values", "peek_min"):
                raise ValueError(f"unknown read method {m!r}")
        if not methods:
            return []
        if all(m == "peek_min" for m in methods):
            one = torch.ones((), dtype=torch.int32, device=self.device)
            merged, _k = _peek_min_impl(self.state, one, c_max=self.c_max,
                                        comm=self._comm)
            head, sizes = _bpq._host_fetch((merged[:1],
                                            self._fetch_sizes()))
            self._refresh_sizes(sizes)
            v = float(head[0])
            return [v if np.isfinite(v) else None] * len(methods)
        a, sizes = _bpq._host_fetch((self._comm.gather(self.state.a),
                                     self._fetch_sizes()))
        self._refresh_sizes(sizes)
        vals: List[float] = []
        for k in range(self.n_shards):
            vals.extend(a[k, 1:int(sizes[k]) + 1].tolist())
        vals.sort()
        return [list(vals) if m == "values"
                else (vals[0] if vals else None) for m in methods]

    def apply_op(self, method: str, input: Any = None) -> Any:
        """Generic single-op entry (the protocol's ``apply`` under a
        non-clashing name — ``apply`` keeps the §4 batch signature)."""
        return substrate.BatchedStructure.apply(self, method, input)

    def occupancy_mirror(self):
        return {"sizes_ub": self._sizes_ub, "total": self._total}


# ---------------------------------------------------------------------------
# Registration (DESIGN.md §16)
# ---------------------------------------------------------------------------
class SequentialBatchedPQ:
    """Protocol-shaped PQ oracle/host mirror with the §4 batch rule,
    INCLUDING the slicing rule for oversized batches: one
    ``update_batch`` lowers onto ≤ c_max slices with extracts and
    inserts advancing together (exactly :func:`expand_rounds`), each
    slice's extracts seeing the pre-SLICE multiset, answered ascending
    with per-slice None padding past the live size; inserts return None.
    ``c_max=None`` means one unbounded slice (the pre-batch rule).  The
    keys live in a binary heap (``heapq``), so an oracle of millions of
    keys costs O(log n) an op."""

    read_only: Set[str] = {"values", "peek_min"}

    def __init__(self, values=None, c_max: Optional[int] = None):
        keys = (values if isinstance(values, np.ndarray)
                else list(values or []))
        # a sorted list is a valid heap
        self._v: List[float] = np.sort(host_keys(keys)).tolist()
        self.c_max = c_max

    def __len__(self) -> int:
        return len(self._v)

    def update_batch(self, methods: Sequence[str],
                     inputs: Sequence[Any]) -> List[Any]:
        ne = 0
        ins: List[float] = []
        for m, i in zip(methods, inputs):
            if m == "insert":
                ins.append(host_key(float(np.float32(i))))
            elif m == "extract_min":
                ne += 1
            else:
                raise ValueError(f"unknown update method {m!r}")
        c = self.c_max if self.c_max is not None else max(1, ne, len(ins))
        take: List[Any] = []
        while ne > 0 or ins:
            k_e, k_i = min(ne, c), min(len(ins), c)
            n = min(k_e, len(self._v))
            take.extend(heapq.heappop(self._v) for _ in range(n))
            take.extend([None] * (k_e - n))           # empty-queue pads
            for v in ins[:k_i]:
                heapq.heappush(self._v, v)
            ne -= k_e
            ins = ins[k_i:]
        out: List[Any] = []
        j = 0
        for m in methods:
            if m == "extract_min":
                out.append(take[j])
                j += 1
            else:
                out.append(None)
        return out

    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        for m in methods:
            if m not in ("values", "peek_min"):
                raise ValueError(f"unknown read method {m!r}")
        vals = self.values() if "values" in methods else []
        return [list(vals) if m == "values"
                else (self._v[0] if self._v else None) for m in methods]

    def apply(self, method: str, input: Any = None) -> Any:
        if method in self.read_only:
            return self.read_batch([method], [input])[0]
        return self.update_batch([method], [input])[0]

    def values(self) -> List[float]:
        return sorted(self._v)


def _gen_update(rng, k, ctx):
    """Mixed insert/extract batches; inserts draw fresh f32 keys, ~40%
    of lanes extract (crossing the empty-queue boundary regularly)."""
    methods, inputs = [], []
    for _ in range(k):
        if rng.random() < 0.4:
            methods.append("extract_min")
            inputs.append(None)
        else:
            methods.append("insert")
            inputs.append(float(np.float32(rng.uniform(-1000.0, 1000.0))))
    return methods, inputs


def _gen_read(rng, k, ctx):
    return ["values"] * k, [None] * k


def _result_ok(method: str, got: Any, want: Any) -> bool:
    def close(g, w):
        if g is None or w is None:
            return g is None and w is None
        return abs(g - w) <= 1e-6 * max(1.0, abs(w))

    if method == "values":
        return (len(got) == len(want)
                and all(close(g, w) for g, w in zip(got, want)))
    return close(got, want)


def _dump_compare(ds: ShardedBatchedPQ, oracle) -> None:
    got, want = ds.values(), oracle.values()
    assert len(got) == len(want), (got, want)
    assert all(abs(g - w) <= 1e-6 * max(1.0, abs(w))
               for g, w in zip(got, want)), (got, want)
    # device heap invariant: slot 0 of every shard is the +inf scratch,
    # parents never exceed children (the §4 layout)
    a, sizes = to_numpy(ds.global_state())
    for k in range(ds.n_shards):
        assert np.isinf(a[k, 0]), a[k, 0]
        assert _bpq.check_heap_property(a[k], int(sizes[k])), (k, a[k])


def _refusal_batch(ds: ShardedBatchedPQ):
    """More inserts than total slot capacity: pigeonhole forces one
    shard past ``capacity - 1`` live slots whatever the routing does."""
    n = (ds.capacity - 1) * ds.n_shards + 1
    return (["insert"] * n, [1000.0 + 2.0 * i for i in range(n)])


def _make(capacity: int = 512, c_max: int = 8, n_shards: int = 2,
          **kw) -> ShardedBatchedPQ:
    return ShardedBatchedPQ(capacity, c_max=c_max, n_shards=n_shards, **kw)


substrate.register(substrate.StructureSpec(
    name="pq",
    module="repro_torch.core.batched_pq",
    title="sharded batched priority queue",
    make=_make,
    make_host=lambda ds: SequentialBatchedPQ(ds.values(),
                                             c_max=ds.c_max),
    gen_update=_gen_update,
    gen_read=_gen_read,
    result_ok=_result_ok,
    dump_compare=_dump_compare,
    refusal_batch=_refusal_batch,
    # the PQ's documented contract is one fetch per CONSUMED apply
    # (AsyncBatchResult), not read-resolves-updates
    reads_resolve_updates=False,
    megapass=True,
    extras={"serve_kw": dict(capacity=4096, c_max=16, n_shards=4),
            # reads the megapass conformance stage drives: peek_min rides
            # the fused rows ("values" dumps the whole heap stack)
            "megapass_read": lambda rng, k, ctx: (["peek_min"] * k,
                                                  [None] * k),
            # the constructor takes placement= (DESIGN.md §18); serve.py
            # keys --mesh-shards off this marker
            "placement": True},
))
