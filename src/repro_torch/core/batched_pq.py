"""Batched binary-heap priority queue (paper §4) — PyTorch, level-synchronous.

The port of ``repro.core.batched_pq``.  The paper applies a batch of
``|E|`` ExtractMin + ``|I|`` Insert requests to a 1-indexed array heap in
``O(c log c + log n)`` parallel time:

1. the combiner finds the ``|E|`` smallest nodes with a Dijkstra-like
   frontier search over the heap (``O(c log c)``) — the ``heap_kmin``
   kernel,
2. ``min(|E|,|I|)`` extracted slots are refilled with insert values; the
   rest pull the heap tail (sequential, as in Gonnet–Munro) — plain torch
   ops, as in the reference,
3. the clients sift-down **in parallel** from the extracted nodes — the
   ``heap_sift`` kernel's level-synchronous wavefront (DESIGN.md §2),
4. remaining inserts descend collectively from the root, each client
   carrying an ``InsertSet`` split by target-leaf counts — the
   ``heap_insert`` kernel, whole level-chunk loop in one launch.

Every phase helper works on a leading shard axis ``(K, cap)``; the single
heap is ``K = 1`` (a view of its ``(cap,)`` array), so the sharded queue
(``sharded_pq.py``) runs the same code over all K shards at once.

Device dispatch: the kernel wrappers pick their path from the heap's
device — a CUDA heap launches the hand-written kernels (or raises), a CPU
heap runs their plain versions.  There is no knob that sends a CUDA heap
down the plain path.

Zero-copy pass (DESIGN.md §10): the reference donates the heap buffers to
its jitted pass; here the pass updates ``state.a`` and ``state.size`` in
place (``donate=False`` is the clone-per-pass twin).  The host slicing
loop keeps every per-slice result on the device — ONE blocking
device→host transfer per ``apply()`` call, through :func:`_host_fetch`.

Packed rows: a pass reads its extract and insert counts on the device, from
one int32 row that also carries the insert values (:func:`pack_rows`), so
one host→device copy feeds a pass (or a dispatch of R passes) and no kernel
takes a count from the host.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels._common import INF, TINY as _TINY
from ..kernels._common import gather_masked as _gather
from ..kernels._common import put as _put
from ..kernels.heap_insert import phase4_plain, phase4_sharded
from ..kernels.heap_kmin import k_smallest_plain, k_smallest_sharded
from ..kernels.heap_sift import sift_wavefront_plain, sift_wavefront_sharded


def _device_get(tree):
    """Copy every tensor of a nested tuple/list to numpy with ONE
    device→host transfer: the leaves are concatenated on the device as
    float64 (exact for f32 keys and int32 counts), fetched once, and split
    back on the host."""
    leaves: List[torch.Tensor] = []

    def flatten(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return len(leaves) - 1
        if isinstance(x, (list, tuple)):
            return type(x), [flatten(y) for y in x]
        return None, x

    spec = flatten(tree)
    host: List[np.ndarray] = []
    if leaves:
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
        flat = flat.cpu().numpy()
        off = 0
        for t in leaves:
            n = t.numel()
            np_dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            host.append(flat[off:off + n].astype(np_dtype).reshape(t.shape))
            off += n

    def rebuild(s):
        if isinstance(s, int):
            return host[s]
        kind, body = s
        if kind is None:
            return body
        return kind(rebuild(y) for y in body)

    return rebuild(spec)


# All device→host transfers on the PQ hot path route through this hook so
# tests can count blocking syncs (DESIGN.md §10: at most one per apply()).
_host_fetch = _device_get


def resolve_device(device=None) -> torch.device:
    """The port runs on the card: ``None`` means ``"cuda"``, and asking
    for CUDA without a CUDA device raises instead of running elsewhere.
    Only an explicit ``device="cpu"`` (the tests) runs on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "to run the plain versions on the host")
    return dev


def _flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """XLA runs flush-to-zero; torch on the CPU and CUDA built without
    ``-ftz`` keep subnormals.  Normalizing keys on entry (subnormals and
    -0.0 become +0.0, DESIGN.md §7) makes both worlds agree."""
    return torch.where(x.abs() < _TINY, torch.zeros_like(x), x)


def require_finite_keys(values) -> None:
    """Reject keys outside the heap's domain (±inf is the empty-slot
    sentinel, NaN breaks the frontier search) — shared by every host
    entry point that accepts keys."""
    if len(values) and not np.all(np.isfinite(np.asarray(values,
                                                         np.float32))):
        raise ValueError(
            "keys must be finite f32: ±inf is the heap's empty-slot "
            "sentinel and NaN breaks the frontier search")


class HeapState(NamedTuple):
    """1-indexed array heap. ``a[0]`` is a scratch slot for masked scatters."""

    a: torch.Tensor      # (capacity,) float32, +inf marks empty slots
    size: torch.Tensor   # () int32


def heap_init(capacity: int, values=None, device=None) -> HeapState:
    dev = resolve_device(device)
    if capacity < 2:
        raise ValueError("capacity must be >= 2 (slot 0 is scratch)")
    a = np.full((capacity,), np.inf, np.float32)
    n = 0
    if values is not None:
        require_finite_keys(values)
        vals = np.asarray(values, np.float32)
        vals = np.sort(np.where(np.abs(vals) < _TINY, np.float32(0.0), vals))
        n = vals.shape[0]
        if n + 1 > capacity:
            raise ValueError("capacity too small")
        # a sorted array satisfies the heap property (parent idx < child idx)
        a[1:n + 1] = vals
    return state_from_numpy(a, n, dev)


def state_from_numpy(a, size, device=None) -> HeapState:
    """A port heap from numpy (e.g. a fetched reference ``HeapState``)."""
    dev = resolve_device(device)
    return HeapState(torch.tensor(np.asarray(a, np.float32), device=dev),
                     torch.tensor(int(size), dtype=torch.int32, device=dev))


def to_numpy(state: HeapState) -> Tuple[np.ndarray, int]:
    """``(a, size)`` of a port heap as numpy/int (one fetch)."""
    a, size = _host_fetch((state.a, state.size))
    return np.asarray(a), int(size)


# ---------------------------------------------------------------------------
# Phase 2 — combiner: refill extracted slots (inserts first, then heap tail)
# ---------------------------------------------------------------------------
def _refill(a, size, out_ids, insert_vals, k_eff, L, c_max, n_pull):
    """a: (K, cap), updated in place; size/k_eff/L: (K,); out_ids and
    insert_vals: (K, c_max).  ``n_pull``: a host-side upper bound on any
    shard's tail pulls ``k_eff - L`` (the loop runs that many steps; the
    reference scans all c_max lanes, the extra ones being no-ops).  A
    pass whose counts live on the device passes c_max.  Returns (a, new
    size)."""
    lane = torch.arange(c_max, device=a.device, dtype=torch.int32)
    Lc, kc = L[:, None], k_eff[:, None]

    # (a) the L smallest extracted nodes receive the L smallest insert values
    _put(a, torch.where(lane < Lc, out_ids, 0), insert_vals)

    # (b) remaining extracted nodes pull the heap tail — processed in
    # DESCENDING node order so a pulled tail slot is never an unprocessed
    # extracted node (tail position == current size >= any remaining id).
    tail_ids = torch.where((lane >= Lc) & (lane < kc), out_ids, -1)
    tail_sorted = torch.sort(tail_ids, dim=1, descending=True).values
    n = min(n_pull, c_max)
    v = tail_sorted[:, :n]
    active = v > 0          # a prefix: the ids (>= 1) sort ahead of the -1s
    # so step t's tail position is size - t, known before the loop: each
    # step is one gather and two scatters.  Masked steps aim at the
    # scratch slot 0, which no active step reads; it is reset after.
    sz = size[:, None] - torch.arange(n, device=a.device, dtype=size.dtype)
    src = sz.clamp(0, a.shape[-1] - 1).long()
    dst = torch.where(active & (v < sz), v, 0).long()
    tail = torch.where(active, sz, 0).long()
    for t in range(n):
        a.scatter_(1, dst[:, t:t + 1], a.gather(1, src[:, t:t + 1]))
        a.scatter_(1, tail[:, t:t + 1], INF)
    a[..., 0] = INF
    return a, size - active.sum(dim=1, dtype=size.dtype)


# ---------------------------------------------------------------------------
# Packed rows: one int32 vector a pass — tag, counts, the insert values' bits
# ---------------------------------------------------------------------------
ROW_TAG, ROW_NE, ROW_NI, ROW_VALS = 0, 1, 2, 3


def pack_rows(rows, c_max: int) -> np.ndarray:
    """``[(tag, ne, buf (c_max,) float32, ni)]`` as one (R, 3 + c_max) int32
    array: the tag, the extract and insert counts, then the f32 bits of the
    insert values.  One host→device copy carries a whole dispatch."""
    out = np.empty((len(rows), ROW_VALS + c_max), np.int32)
    for r, (tag, ne, buf, ni) in enumerate(rows):
        out[r, :ROW_VALS] = (tag, ne, ni)
        out[r, ROW_VALS:] = np.asarray(buf, np.float32).view(np.int32)
    return out


def row_fields(row: torch.Tensor, c_max: int):
    """``(tag, ne, ni, insert values)`` of one packed device row: () int32
    tensors with the counts clamped to c_max, and a (c_max,) float32 view
    of the values; nothing is read on the host."""
    ne = torch.clamp(row[ROW_NE], max=c_max)
    ni = torch.clamp(row[ROW_NI], max=c_max)
    return row[ROW_TAG], ne, ni, row[ROW_VALS:].view(torch.float32)


def _phases12(a, size, n_extract, insert_vals, n_insert, *, c_max: int,
              phase1: Tuple[torch.Tensor, torch.Tensor], n_pull: int):
    """Combiner phases 1–2 + client-phase setup, over a shard axis.

    ``n_extract``/``n_insert``: (K,) int32 per-shard counts;
    ``insert_vals``: (K, c_max); ``phase1``: each shard's first
    ``n_extract`` smallest nodes ``(ids, vals)``, ascending, (0, +inf)
    padded; ``n_pull``: host bound on the tail pulls (see :func:`_refill`).
    Returns ``(a, size, out_vals, k_eff, starts, active, rem,
    m_left)``: the refilled heap (in place), the extracted values, the
    sift wavefront's start cursors, and the sorted suffix of insert
    values still to be placed by phase 4.
    """
    lane = torch.arange(c_max, device=a.device, dtype=torch.int32)
    n_extract = torch.clamp(n_extract, max=c_max)
    n_insert = torch.clamp(n_insert, max=c_max)
    insert_vals = _flush_subnormals(insert_vals.to(torch.float32))
    insert_vals = torch.sort(torch.where(lane < n_insert[:, None],
                                         insert_vals, INF), dim=1).values
    out_ids, out_vals = phase1
    k_eff = torch.minimum(n_extract, size)
    L = torch.minimum(k_eff, n_insert)

    a, size = _refill(a, size, out_ids, insert_vals, k_eff, L, c_max,
                      n_pull)

    kc = k_eff[:, None]
    starts = torch.where(lane < kc, out_ids, 0)
    active = (lane < kc) & (starts >= 1) & (starts <= size[:, None])

    m_left = n_insert - L
    rem = _gather(insert_vals, lane + L[:, None], lane < m_left[:, None])
    return a, size, out_vals, k_eff, starts, active, rem, m_left


class Phases(NamedTuple):
    """The three kernel phases of a pass: ``kmin(a, size, ne, c_max=)``,
    ``sift(a, size, starts, active)``, ``phase4(a, size, rem, m_left)``."""

    kmin: Callable
    sift: Callable
    phase4: Callable


# The pass always runs these: device-dispatching wrappers (kernel on a CUDA
# heap, plain version on a CPU heap).
KERNEL_PHASES = Phases(k_smallest_sharded, sift_wavefront_sharded,
                       phase4_sharded)
# The plain versions on any device — the yardstick ``chip_smoke.py`` holds
# the kernel pass against on the card; no entry point takes them.
PLAIN_PHASES = Phases(k_smallest_plain, sift_wavefront_plain, phase4_plain)


# ---------------------------------------------------------------------------
# The full batch application (paper §4, COMBINER_CODE + CLIENT_CODE fused)
# ---------------------------------------------------------------------------
def apply_batch_impl(state: HeapState, row: torch.Tensor, *, c_max: int,
                     n_pull: Optional[int] = None,
                     phases: Phases = KERNEL_PHASES,
                     ) -> Tuple[HeapState, torch.Tensor, torch.Tensor]:
    """One combined batch on the heap, in place (phases 1–4).

    ``row``: one packed (3 + c_max,) int32 row on the heap's device
    (:func:`pack_rows`; its tag is not read): the extract and insert
    counts (≤ c_max are used) and the insert values.  ``n_pull``: a host
    bound on the tail pulls, ``max(ne - ni, 0)`` when the caller knows the
    counts (None: c_max).  Returns ``(state, extracted (c_max,) ascending
    +inf-padded, k_eff ())`` where ``k_eff = min(n_extract, size)``.
    Launches each kernel once on a CUDA heap and never synchronises.

    ``phases`` is the yardstick seam: no entry point passes it, and only
    ``chip_smoke.py`` swaps in :data:`PLAIN_PHASES` (or checked phases) to
    hold the kernel pass against the plain pass on the card.
    """
    _tag, ne, ni, insert_vals = row_fields(row, c_max)
    a, size = state.a[None], state.size.reshape(1)
    phase1 = phases.kmin(a, size, ne, c_max=c_max)
    a, size2, out_vals, k_eff, starts, active, rem, m_left = _phases12(
        a, size, ne.reshape(1), insert_vals[None], ni.reshape(1),
        c_max=c_max, phase1=phase1,
        n_pull=c_max if n_pull is None else n_pull)
    phases.sift(a, size2, starts, active)
    _, new_size = phases.phase4(a, size2, rem, m_left)
    state.size.copy_(new_size[0])
    return state, out_vals[0], k_eff[0]


def apply_batch(state: HeapState, row: torch.Tensor, *, c_max: int,
                n_pull: Optional[int] = None
                ) -> Tuple[HeapState, torch.Tensor, torch.Tensor]:
    """Apply a combined batch (one packed row), updating ``state`` in
    place (the port's counterpart of the reference's donated jit)."""
    return apply_batch_impl(state, row, c_max=c_max, n_pull=n_pull)


def apply_batch_undonated(state: HeapState, row: torch.Tensor, *,
                          c_max: int, n_pull: Optional[int] = None
                          ) -> Tuple[HeapState, torch.Tensor, torch.Tensor]:
    """Ablation twin (EXPERIMENTS §Ablations): the same pass on a clone —
    the heap buffers are copied every pass, ``state`` stays untouched."""
    clone = HeapState(state.a.clone(), state.size.clone())
    return apply_batch_impl(clone, row, c_max=c_max, n_pull=n_pull)


# ---------------------------------------------------------------------------
# Device command queue: R rounds back to back (DESIGN.md §12)
# ---------------------------------------------------------------------------
def apply_rounds(state: HeapState, specs, *, c_max: int, donate: bool = True,
                 ) -> Tuple[HeapState, torch.Tensor, torch.Tensor]:
    """R sequential combined batches, one pass each, no host sync between.

    ``specs``: ``[(ne, buf (c_max,) float32 numpy, ni)]`` as
    :func:`expand_rounds` makes them, packed into rows and copied to the
    device at once.  Returns ``(state, outs (R, c_max), k_effs (R,))``.
    (The reference runs the rounds as one ``lax.scan`` program; here they
    are a loop of passes on one stream.)"""
    if not donate:
        state = HeapState(state.a.clone(), state.size.clone())
    rows = torch.from_numpy(pack_rows(
        [(0, ne, buf, ni) for ne, buf, ni in specs], c_max)).to(
            state.a.device, non_blocking=True)
    outs, k_effs = [], []
    for r, (ne, _buf, ni) in enumerate(specs):
        state, out, k_eff = apply_batch_impl(state, rows[r], c_max=c_max,
                                             n_pull=max(ne - ni, 0))
        outs.append(out)
        k_effs.append(k_eff)
    return state, torch.stack(outs), torch.stack(k_effs)


# ---------------------------------------------------------------------------
# Reference oracle (paper batch semantics, sequential numpy)
# ---------------------------------------------------------------------------
def apply_batch_reference(values, n_extract, insert_vals):
    """Set-semantics oracle: extracted = k smallest of the pre-batch heap,
    new multiset = (old \\ extracted) ∪ inserts.  Returns (extracted_sorted,
    new_multiset_sorted)."""
    vals = sorted(values)
    k = min(n_extract, len(vals))
    extracted = vals[:k]
    remaining = vals[k:] + list(insert_vals)
    return extracted, sorted(remaining)


def check_heap_property(a: np.ndarray, size: int) -> bool:
    a = np.asarray(a)
    n = int(size)
    if n < 2:
        return True
    v = np.arange(2, n + 1)
    return bool(np.all(a[v // 2] <= a[v]))


# ---------------------------------------------------------------------------
# Host-facing wrappers — sync-free slicing (DESIGN.md §10)
# ---------------------------------------------------------------------------
class AsyncBatchResult:
    """Deferred host view of one ``apply()`` call's extracted values.

    Holds the per-slice device tensors (+inf-padded, ascending per slice)
    and performs ONE blocking device→host transfer, at first
    :meth:`result` call — the device keeps computing while the host is
    free to publish more batches.  The +inf padding doubles as the
    empty-queue sentinel: a slice that asked for ``ne`` extracts but
    fetched ``k`` finite values reports ``ne - k`` ``None`` entries.
    """

    def __init__(self, slice_ne: List[int], slice_vals: List[torch.Tensor],
                 extra: Optional[Callable[[], object]] = None,
                 on_fetch: Optional[Callable[[object], None]] = None):
        self._ne = slice_ne
        self._vals = slice_vals
        self._extra = extra
        self._on_fetch = on_fetch
        self._out: Optional[list] = None

    def result(self) -> list:
        """Extracted values ascending per slice, ``None``-padded for
        extracts that found the queue empty (cached after first call)."""
        if self._out is None:
            # ``extra`` is evaluated NOW, not at apply time: under
            # pipelined consumption the fetched sizes then reflect every
            # dispatched slice — exactly the prefix the host mirror has
            # accounted.
            extra_dev = self._extra() if self._extra is not None else None
            vals_h, extra_h = _host_fetch((self._vals, extra_dev))
            out: list = []
            for ne, vals in zip(self._ne, vals_h):
                vals = np.asarray(vals)
                k = int(np.isfinite(vals[:ne]).sum())
                out.extend(vals[:k].tolist())
                out.extend([None] * (ne - k))      # empty-queue extracts
            if self._on_fetch is not None:
                self._on_fetch(extra_h)
            self._out = out
            self._vals = self._extra = self._on_fetch = None
        return self._out


def _slices(extracts: int, inserts: list, c_max: int):
    """The ≤ c_max slices of one combined batch, extracts and inserts
    advancing together: ``[(ne, buf (c_max,) float32, ni)]``."""
    out = []
    while extracts > 0 or inserts:
        ne = min(extracts, c_max)
        ni = min(len(inserts), c_max)
        buf = np.full((c_max,), np.inf, np.float32)
        buf[:ni] = inserts[:ni]
        out.append((ne, buf, ni))
        extracts -= ne
        inserts = inserts[ni:]
    return out


def apply_sliced_async(step, c_max: int, extracts: int, inserts,
                       *, extra=None,
                       on_fetch: Optional[Callable[[object], None]] = None,
                       ) -> AsyncBatchResult:
    """Shared host-side batching loop for the PQ wrappers — sync-free.

    Applies a combined batch of ``extracts`` ExtractMin + ``inserts`` in
    ≤ c_max slices; ``step(ne, buf, ni) -> (vals, k_eff)`` runs one pass
    over one slice (and updates the caller's state).  The loop never reads
    a device value; the per-slice results stay on the device inside the
    returned :class:`AsyncBatchResult`.  ``extra`` (a thunk returning
    device tensors, evaluated at result consumption) rides the same one
    blocking transfer and is handed to ``on_fetch``.
    """
    inserts = list(inserts)
    require_finite_keys(inserts)
    slice_ne: List[int] = []
    slice_vals: List[torch.Tensor] = []
    for ne, buf, ni in _slices(int(extracts), inserts, c_max):
        vals, _k_eff = step(ne, buf, ni)   # k_eff stays on device, unused
        if ne:
            slice_ne.append(ne)
            slice_vals.append(vals)
    return AsyncBatchResult(slice_ne, slice_vals, extra=extra,
                            on_fetch=on_fetch)


def apply_sliced(step, c_max: int, extracts: int, inserts) -> list:
    """Blocking convenience wrapper over :func:`apply_sliced_async`."""
    return apply_sliced_async(step, c_max, extracts, inserts).result()


# ---------------------------------------------------------------------------
# Multi-round host plumbing (DESIGN.md §12): per-round handles, one fetch
# ---------------------------------------------------------------------------
class _RoundsFetch:
    """ONE blocking transfer shared by every round of a rounds dispatch:
    the (R, c_max) output (plus an optional ``extra`` thunk, e.g. the
    shard sizes) is fetched once, at the first consuming :meth:`rows`."""

    def __init__(self, vals_dev, extra: Optional[Callable[[], object]] = None,
                 on_fetch: Optional[Callable[[object], None]] = None):
        self._vals = vals_dev
        self._extra = extra
        self._on_fetch = on_fetch
        self._host: Optional[np.ndarray] = None

    def rows(self) -> np.ndarray:
        if self._host is None:
            extra_dev = self._extra() if self._extra is not None else None
            vals_h, extra_h = _host_fetch((self._vals, extra_dev))
            if self._on_fetch is not None:
                self._on_fetch(extra_h)
            self._host = np.asarray(vals_h)
            self._vals = self._extra = self._on_fetch = None
        return self._host


class RoundResult:
    """Deferred host view of ONE round of a rounds dispatch — the
    :class:`AsyncBatchResult` contract, with the blocking transfer shared
    across all rounds of the dispatch (:class:`_RoundsFetch`)."""

    def __init__(self, slice_ne: List[int], row_ids: List[int],
                 shared: Optional[_RoundsFetch]):
        self._ne = slice_ne
        self._rows = row_ids
        self._shared = shared
        self._out: Optional[list] = None

    def result(self) -> list:
        if self._out is None:
            rows = self._shared.rows() if self._shared is not None else None
            out: list = []
            for ne, i in zip(self._ne, self._rows):
                vals = np.asarray(rows[i])
                k = int(np.isfinite(vals[:ne]).sum())
                out.extend(vals[:k].tolist())
                out.extend([None] * (ne - k))      # empty-queue extracts
            self._out = out
            self._shared = None
        return self._out


def expand_rounds(rounds, c_max: int):
    """Lower consumer rounds onto ≤ c_max rows (host-side, sync-free).

    ``rounds``: sequence of ``(extracts, inserts)`` pairs.  Oversized
    rounds are sliced exactly like :func:`apply_sliced_async`, so every
    row is a valid single-batch application in round order.  Returns
    ``(specs, layout)``: ``specs`` is the flat row list ``[(ne, buf,
    ni)]``; ``layout[r]`` is ``(slice_ne, row_ids)``, which reassembles
    round ``r``'s answer.  (The reference pads the row count to a power
    of two here to bound its jit cache; the sharded queue pads the rows of
    a whole dispatch instead, to bound its captured CUDA graphs.)"""
    specs: List[Tuple[int, np.ndarray, int]] = []
    layout: List[Tuple[List[int], List[int]]] = []
    for extracts, inserts in rounds:
        inserts = list(inserts)
        require_finite_keys(inserts)
        extracts = int(extracts)
        if extracts < 0:
            raise ValueError("extracts must be >= 0")
        slice_ne: List[int] = []
        row_ids: List[int] = []
        for ne, buf, ni in _slices(extracts, inserts, c_max):
            if ne:
                slice_ne.append(ne)
                row_ids.append(len(specs))
            specs.append((ne, buf, ni))
        layout.append((slice_ne, row_ids))
    return specs, layout


class BatchedPriorityQueue:
    """Device-resident PQ with batch application (the §4 data structure).

    ``device=None`` means the card (``"cuda"``) and raises without one;
    the tests pass ``device="cpu"``.  ``donate=True`` (default) updates
    the heap in place every pass (zero-copy, DESIGN.md §10);
    ``donate=False`` is the clone-per-pass ablation twin.

    Capacity guard: the host mirrors the heap's size exactly without a
    device read (a pass extracts ``min(ne, size)`` and adds ``ni``) and
    refuses, before any slice reaches the device, a batch that would
    overflow the capacity.  (The reference's scatter drops such keys
    silently and lets ``size`` pass the capacity.)
    """

    def __init__(self, capacity: int, c_max: int, values=None,
                 donate: bool = True, device=None):
        if c_max < 1:
            raise ValueError("c_max must be >= 1")
        self.c_max = int(c_max)
        self.capacity = int(capacity)
        self.donate = bool(donate)
        self.device = resolve_device(device)
        self.state = heap_init(capacity, values, self.device)
        self._size = 0 if values is None else len(values)

    def __len__(self) -> int:
        return int(self.state.size)

    def _to_device(self, buf: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(buf).to(self.device, non_blocking=True)

    def _grow(self, rounds) -> int:
        """The size after ``rounds`` ([(extracts, n_inserts)], sliced as
        :func:`apply_sliced_async` slices them); raises ``ValueError`` if
        any slice would overflow the capacity."""
        size = self._size
        for extracts, n_ins in rounds:
            e, i = max(int(extracts), 0), int(n_ins)
            while e > 0 or i > 0:
                ne, ni = min(e, self.c_max), min(i, self.c_max)
                size += ni - min(ne, size)
                if size + 1 > self.capacity:
                    raise ValueError(
                        f"heap capacity {self.capacity} exceeded: the batch "
                        f"would grow the heap to {size} keys")
                e, i = e - ne, i - ni
        return size

    def _step(self, ne, buf, ni):
        fn = apply_batch if self.donate else apply_batch_undonated
        row = self._to_device(pack_rows([(0, ne, buf, ni)], self.c_max)[0])
        self.state, vals, k_eff = fn(self.state, row, c_max=self.c_max,
                                     n_pull=max(ne - ni, 0))
        return vals, k_eff

    def apply_async(self, extracts: int, inserts) -> AsyncBatchResult:
        """Apply a combined batch; the extracted values stay on the device
        until ``.result()`` — one blocking host sync per call, not per
        slice.  Batches larger than c_max are applied in c_max slices."""
        inserts = list(inserts)
        size = self._grow([(extracts, len(inserts))])
        out = apply_sliced_async(self._step, self.c_max, extracts, inserts)
        self._size = size
        return out

    def apply(self, extracts: int, inserts) -> list:
        """Apply a combined batch; returns the extracted values (floats)."""
        return self.apply_async(extracts, inserts).result()

    def apply_rounds_async(self, rounds) -> List[RoundResult]:
        """Apply R sequential combined batches back to back with no host
        sync between them (the §12 command queue).  ``rounds``:
        [(extracts, inserts)]; oversized rounds are sliced onto extra
        rows.  Returns one :class:`RoundResult` per round; all rounds
        share one blocking fetch, paid by the first consumed round."""
        rounds = [(e, list(ins)) for e, ins in rounds]
        specs, layout = expand_rounds(rounds, self.c_max)
        if not specs:
            return [RoundResult(sn, ri, None) for sn, ri in layout]
        size = self._grow([(e, len(ins)) for e, ins in rounds])
        self.state, outs, _k = apply_rounds(self.state, specs,
                                            c_max=self.c_max,
                                            donate=self.donate)
        self._size = size
        shared = _RoundsFetch(outs)
        return [RoundResult(sn, ri, shared) for sn, ri in layout]

    def apply_rounds(self, rounds) -> List[list]:
        """Blocking :meth:`apply_rounds_async`: per-round answer lists."""
        return [h.result() for h in self.apply_rounds_async(rounds)]

    def values(self) -> list:
        a, n = to_numpy(self.state)
        return sorted(a[1:n + 1].tolist())
