"""Device-resident batched dynamic graph (DESIGN.md §11) — the §5.1
read-dominated application on the card.

The port of ``repro.core.device_graph``.  The edges and the refresh
bookkeeping live on the device, so one combining pass costs one update
pass plus one read pass with a single blocking fetch:

* **edge buffer** — a fixed-capacity endpoint-array pair plus a validity
  mask.  One update pass applies ≤ ``c_max`` MIXED insert/delete requests
  with sequential arrival-order semantics: per-lane results come from the
  last-earlier-same-edge chain rule, while the buffer takes only the NET
  effect per edge class (removals free slots, additions claim them by
  prefix-sum rank; transient insert+delete pairs never touch memory).
* **device-resident dirty tracking** — the state carries a pending-edge
  buffer, a ``dirty_full`` flag and a rebuild counter.  The update pass
  appends netted-in edges to the pending buffer and raises ``dirty_full``
  when an edge is netted OUT (or the pending buffer overflows).
* **read pass** — a ``connected`` batch runs refresh + gather/compare
  with no host read: the ``label_prop`` kernel is launched twice, gated
  on the device by ``dirty_full`` — the full rebuild over the whole edge
  buffer when it is set, the contracted-graph union-find fast path over
  the pending inserts when it is not (a no-op when nothing is pending).
  On a CPU graph the same calls run the kernel's plain version.
* **placement** (DESIGN.md §18) — under a ``MeshPlacement`` only the full
  rebuild is distributed: each rank runs the fixpoint over its block of
  the edge slots and one more launch merges the gathered tables
  (``label_prop.propagate_collective``), still gated on the device by
  ``dirty_full``.  ``GraphState`` has no K axis, so the state, the update
  passes and the contracted-graph merge stay replicated on every rank, as
  in the reference (the "graph honesty note").
* **sync-free update publishing** — ``update_batch_async`` leaves the
  per-request result masks on the device; they ride the next read's
  single blocking fetch (:data:`_host_fetch`).

Every pass updates the state in place (the reference donates it);
``donate=False`` is the clone-per-pass ablation twin.  The wrapper keeps a
host mirror of the live edge count for the capacity guard.  It is not
thread-safe; the read-optimized combiner serializes it.

Differences from the reference that change no result: the full rebuild
runs over the whole edge buffer (invalid slots are (0, 0) no-ops) instead
of compacting to a pow2 ``e_bound``, the free-slot search is a cumsum rank
and a scatter instead of ``jnp.nonzero``, and round counts and query
widths are not padded to powers of two (there is no jit cache to bound).
R rounds run as R passes back to back on one stream with no host sync
between them (the reference runs one ``lax.scan`` program).
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Set, Tuple)

import numpy as np
import torch

from ..kernels.label_prop import propagate, propagate_collective
from . import substrate
from .batched_pq import _device_get
from .faults import make_guard
from .placement import STACKED, led, placed_device, resolve_placement

# All device→host transfers on the graph hot path route through this hook
# so tests can count blocking syncs (same idiom as batched_pq._host_fetch).
_host_fetch = _device_get


class GraphState(NamedTuple):
    """Device-resident dynamic graph: edge buffer + labels + dirty state.

    The edge arrays and the pending buffer carry one extra SCRATCH slot at
    index ``capacity`` (resp. ``pend_cap``): predicated scatters route
    every inactive lane there, so an active lane never collides with an
    inactive write-back."""

    eu: torch.Tensor          # (capacity+1,) int32 — endpoint min
    ev: torch.Tensor          # (capacity+1,) int32 — endpoint max
    valid: torch.Tensor       # (capacity+1,) bool — [capacity] stays False
    labels: torch.Tensor      # (n,) int32 — component-min labels (maybe stale)
    pend: torch.Tensor        # (2, pend_cap+1) int32 — inserted, not merged
    n_pend: torch.Tensor      # () int32
    dirty_full: torch.Tensor  # () bool — labels need a full rebuild
    n_full: torch.Tensor      # () int32 — full-rebuild counter
    n_fast: torch.Tensor      # () int32 — fast-merge counter (the port's
    #                           instrumentation; the reference has none)


def clone_state(state: GraphState) -> GraphState:
    return GraphState(*(t.clone() for t in state))


def init_state(n: int, capacity: int, c_max: int, device) -> GraphState:
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return GraphState(
        eu=torch.zeros(capacity + 1, **i32),
        ev=torch.zeros(capacity + 1, **i32),
        valid=torch.zeros(capacity + 1, dtype=torch.bool, device=dev),
        labels=torch.arange(n, **i32),
        pend=torch.zeros((2, 2 * c_max + 1), **i32),
        n_pend=torch.zeros((), **i32),
        dirty_full=torch.zeros((), dtype=torch.bool, device=dev),
        n_full=torch.zeros((), **i32),
        n_fast=torch.zeros((), **i32))


# ---------------------------------------------------------------------------
# Combining passes (in place: the reference's donated programs)
# ---------------------------------------------------------------------------
def _update_impl(state: GraphState, buv: torch.Tensor, is_ins: torch.Tensor,
                 nb: int) -> Tuple[GraphState, torch.Tensor]:
    """Apply ≤ c_max MIXED insert/delete requests as ONE pass, in place.

    ``buv``: (2, c) int32 endpoints; ``is_ins``: (c,) bool op selector;
    ``nb``: live lane count (host int).  A lane's edge is "present before"
    iff the LAST earlier lane touching the same edge was an insert,
    falling back to buffer presence for the class's first lane; the buffer
    takes the NET effect per edge class.  Netted-in edges append to the
    pending buffer; a netted-out edge or a pending overflow raises
    ``dirty_full`` and clears it.  Returns ``(state, ok (c,) bool)``, the
    results left on the device."""
    eu, ev, valid, labels, pend, n_pend, dirty_full = state[:7]
    dev = eu.device
    cap = eu.shape[0] - 1                             # [cap] is scratch
    c = buv.shape[1]
    pend_cap = pend.shape[1] - 1                      # [:, pend_cap] scratch
    lane = torch.arange(c, dtype=torch.int32, device=dev)
    u = torch.minimum(buv[0], buv[1])
    v = torch.maximum(buv[0], buv[1])
    act = (lane < nb) & (u != v)      # self-loops are never stored
    match = (valid[None, :] & (eu[None, :] == u[:, None])
             & (ev[None, :] == v[:, None]))           # (c, capacity+1)
    in_buf = match.any(dim=1)
    slot = match.to(torch.uint8).argmax(dim=1)        # unique if in_buf

    same = (u[:, None] == u[None, :]) & (v[:, None] == v[None, :])
    earlier = same & act[None, :] & (lane[None, :] < lane[:, None])
    has_prev = earlier.any(dim=1)
    prev_idx = torch.where(earlier, lane[None, :], -1).argmax(dim=1)
    present_before = torch.where(has_prev, is_ins[prev_idx], in_buf)
    ok = act & torch.where(is_ins, ~present_before, present_before)

    is_last = act & ~(same & act[None, :]
                      & (lane[None, :] > lane[:, None])).any(dim=1)
    rem = is_last & ~is_ins & in_buf                  # netted out
    add = is_last & is_ins & ~in_buf                  # netted in

    # predicated scatters: inactive lanes write the scratch slot its own
    # value, so they never collide with an active lane's target
    tgt = torch.where(rem, slot, cap)
    valid[tgt] = torch.where(rem, False, valid[tgt])

    idx = torch.arange(cap + 1, device=dev)
    free = ~valid & (idx < cap)                       # post-removal slots
    rank = torch.cumsum(add.to(torch.int32), 0) - 1
    # device-side overflow clamp (the host guard refuses earlier)
    add = add & (rank < free.sum())
    # the first c free slots by rank (the reference's jnp.nonzero(size=c,
    # fill_value=cap)); ranks past c land on the dropped entry c
    frank = torch.cumsum(free.to(torch.int32), 0) - 1
    free_idx = torch.full((c + 1,), cap, dtype=torch.int64, device=dev)
    free_idx.scatter_(0, torch.where(free & (frank < c), frank, c), idx)
    tgt = torch.where(add, free_idx[rank.clamp(0, c - 1)], cap)
    eu[tgt] = torch.where(add, u, eu[tgt])
    ev[tgt] = torch.where(add, v, ev[tgt])
    valid[tgt] = torch.where(add, True, valid[tgt])
    valid[cap:].zero_()                               # scratch stays dead

    # -- device-resident dirty tracking
    n_add = add.sum()
    go_full = dirty_full | rem.any() | (n_pend + n_add > pend_cap)
    app = add & ~go_full
    ptgt = torch.where(app, (n_pend + rank).clamp(0, pend_cap - 1),
                       pend_cap)
    pend[0, ptgt] = torch.where(app, u, pend[0, ptgt])
    pend[1, ptgt] = torch.where(app, v, pend[1, ptgt])
    n_pend.copy_(torch.where(go_full, 0, n_pend + n_add))
    dirty_full.copy_(go_full)
    return state, ok


def _read_impl(state: GraphState, uv: torch.Tensor, *,
               prop: Callable = propagate, comm=STACKED, full: bool = True
               ) -> Tuple[GraphState, torch.Tensor]:
    """Refresh + gather/compare for one read batch, in place, with no host
    read: the full rebuild runs iff ``dirty_full``, the contracted-graph
    merge of the pending inserts iff not (identity when none pend) — both
    gated inside the launch.  ``n_full`` counts full branches, ``n_fast``
    merge branches.  ``comm``: a mesh placement's collectives split the
    full rebuild's edge slots across its ranks
    (:func:`~repro_torch.kernels.label_prop.propagate_collective`); the
    stacked default runs it as one launch.  ``full``: the host's bound —
    False guarantees ``dirty_full`` is clear, and a mesh then skips the
    collective rebuild on every rank (the stacked launch ignores it).

    ``prop`` is the yardstick seam: no entry point passes it, and only
    ``chip_smoke.py`` swaps in ``propagate_plain`` to hold the kernel pass
    against the plain pass on the card."""
    eu, ev, valid, labels, pend, n_pend, dirty_full, n_full, n_fast = state
    if comm is STACKED:
        prop(eu, ev, labels, valid=valid, when=dirty_full)
    elif full:
        propagate_collective(eu, ev, labels, comm, valid=valid,
                             when=dirty_full, prop=prop)
    prop(pend[0], pend[1], labels, e_live=n_pend, relabel=True,
         unless=dirty_full)
    n_full += dirty_full.to(torch.int32)
    n_fast += (~dirty_full & (n_pend > 0)).to(torch.int32)
    n_pend.zero_()
    dirty_full.zero_()
    return state, labels[uv[0].long()] == labels[uv[1].long()]


def update_pass(state, buv, is_ins, nb, *, donate: bool = True):
    """One update slice; ``donate=False`` runs it on a clone (the
    copy-per-pass ablation twin) and leaves ``state`` untouched."""
    return _update_impl(state if donate else clone_state(state), buv,
                        is_ins, nb)


def update_rounds(state, buv, is_ins, nb: Sequence[int], *,
                  donate: bool = True):
    """R sequential ≤ c_max update slices back to back (DESIGN.md §12):
    ``buv`` (R, 2, c), ``is_ins`` (R, c), ``nb`` R host ints.  Returns
    ``(state, oks (R, c))``; no host sync between the slices."""
    if not donate:
        state = clone_state(state)
    oks = [_update_impl(state, buv[r], is_ins[r], nb[r])[1]
           for r in range(len(nb))]
    return state, torch.stack(oks)


def read_pass(state, uv, *, donate: bool = True, prop: Callable = propagate,
              comm=STACKED, full: bool = True):
    return _read_impl(state if donate else clone_state(state), uv,
                      prop=prop, comm=comm, full=full)


# megapass row tags (DESIGN.md §17)
MEGA_UPDATE, MEGA_READ = 0, 1


def mixed_rounds_pass(state, tags: Sequence[int], buv, flags,
                      nb: Sequence[int], *, donate: bool = True,
                      prop: Callable = propagate, comm=STACKED,
                      full: Optional[Sequence[bool]] = None):
    """R heterogeneous update/read rows back to back (DESIGN.md §17): per
    row, the update pass or the refresh+gather read pass.  ``buv`` (R, 2,
    c) endpoints or query pairs, ``flags`` (R, c) insert selectors,
    ``nb`` live lanes per update row, ``full`` (R host bools, read rows
    read; default all True) the host's rebuild bound of
    :func:`_read_impl`.  Returns ``(state, oks (R, c))`` — update rows
    stack their ok masks, read rows their answers."""
    if not donate:
        state = clone_state(state)
    oks = []
    for r, tag in enumerate(tags):
        if tag == MEGA_READ:
            oks.append(_read_impl(state, buv[r], prop=prop, comm=comm,
                                  full=full is None or full[r])[1])
        else:
            oks.append(_update_impl(state, buv[r], flags[r], nb[r])[1])
    return state, torch.stack(oks)


def _connected_pairs(labels: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Lean read: labels known-current, no refresh machinery launched."""
    return labels[uv[0].long()] == labels[uv[1].long()]


class AsyncUpdateResult:
    """Deferred host view of one update batch's per-request results.

    The ok masks stay on the device until the first :meth:`result` call —
    or until the owning graph's next read pass fetches them inside its
    single blocking transfer.  Resolution also re-tightens the owner's
    live-edge-count mirror to the exact value.

    Elimination bookkeeping (DESIGN.md §12): the dispatch carries ONE lane
    per distinct edge class (the class's LAST op); every other op's result
    is reconstructed host-side at resolve time via the arrival-order chain
    rule (``present = ok XOR is_ins``); self-loops are answered ``False``
    without any device work.
    """

    def __init__(self, owner: "DeviceGraph", masks: List[torch.Tensor],
                 n_ops: int, classes: List[List[Tuple[int, bool]]],
                 lane_counts: List[int], c_max: int):
        self._owner: Optional["DeviceGraph"] = owner
        self.masks = masks
        self._n_ops = n_ops
        self._classes = classes          # per device lane, dispatch order
        self._lane_counts = lane_counts  # live lanes per dispatched row
        self._c_max = c_max
        self._out: Optional[List[bool]] = None

    def _resolve(self, masks_h) -> None:
        """Apply fetched masks to the owner's mirrors and chain-reconstruct
        every op's arrival-order result."""
        if masks_h and self._lane_counts:
            rows = np.concatenate(
                [np.asarray(m).reshape(-1, self._c_max) for m in masks_h],
                axis=0)
            ok_dev = np.concatenate(
                [rows[r, :nb] for r, nb in enumerate(self._lane_counts)])
        else:
            ok_dev = np.zeros((0,), bool)
        out = np.zeros((self._n_ops,), bool)    # self-loops stay False
        adds = removals = lane_inserts = 0
        for lane, ops in enumerate(self._classes):
            is_ins_last = ops[-1][1]
            okl = bool(ok_dev[lane])
            adds += okl and is_ins_last
            removals += okl and not is_ins_last
            lane_inserts += is_ins_last
            # lane answer -> buffer presence before the class's first op
            present = (not okl) if is_ins_last else okl
            for idx, ins in ops:
                out[idx] = (not present) if ins else present
                present = ins            # outcome determines presence
        owner = self._owner
        if owner is not None:
            owner._n_edges += adds - removals
            owner._outstanding_ins -= lane_inserts
        self._out = out.tolist()
        self._owner = None
        self.masks = []

    def result(self) -> List[bool]:
        """Per-request results in arrival order (cached after first call)."""
        if self._out is None:
            self._owner._resolve_through(self)
        return self._out


class _GraphMegaFetch:
    """One shared blocking fetch for every handle of one megapass: the
    FIRST handle resolved triggers the single ``_host_fetch`` (which also
    drains older outstanding update handles), then resolves every
    megapass update round in dispatch order."""

    def __init__(self, owner: "DeviceGraph", oks: torch.Tensor):
        self._owner: Optional["DeviceGraph"] = owner
        self._oks = oks
        self._upd: List[Tuple[AsyncUpdateResult, int, int]] = []
        self._rows: Optional[np.ndarray] = None

    def rows(self) -> np.ndarray:
        if self._rows is None:
            got = self._owner._resolve_through(None, extra=self._oks)
            rows = np.asarray(got)
            for inner, lo, hi in self._upd:
                if inner._out is None:
                    inner._resolve([rows[lo:hi]])
            self._rows = rows
            self._owner = self._oks = None
            self._upd = []
        return self._rows


class _MegaUpdateHandle:
    """Megapass update-round handle: resolves through the shared fetch."""

    def __init__(self, shared: _GraphMegaFetch, inner: AsyncUpdateResult):
        self._shared, self._inner = shared, inner

    def result(self) -> List[bool]:
        if self._inner._out is None:
            self._shared.rows()
        return self._inner._out


class _GraphReadRound:
    """Megapass read-round handle: one bool per query pair, masked out of
    the round's (c_max,) output rows by per-row live counts."""

    def __init__(self, shared: _GraphMegaFetch, row_lo: int,
                 counts: List[int]):
        self._shared, self._row_lo, self._counts = shared, row_lo, counts

    def result(self) -> List[bool]:
        rows = self._shared.rows()
        out: List[bool] = []
        for r, nc in enumerate(self._counts):
            out.extend(bool(x) for x in rows[self._row_lo + r, :nc])
        return out


def _classes(methods: Sequence[str], arr: np.ndarray):
    """The elimination pre-pass: ops grouped by normalized edge class in
    first-touch order (self-loops dropped — they never dispatch)."""
    for m in methods:
        if m not in ("insert", "delete"):
            raise ValueError(f"unknown update method {m!r}")
    by_edge: Dict[Tuple[int, int], List[Tuple[int, bool]]] = {}
    for i in range(arr.shape[1]):
        u, v = int(arr[0, i]), int(arr[1, i])
        if u == v:
            continue
        by_edge.setdefault((min(u, v), max(u, v)), []).append(
            (i, methods[i] == "insert"))
    return list(by_edge.values())


def _update_rows(classes, arr: np.ndarray, c: int):
    """One lane per class (its LAST op) packed into ≤ c-wide rows:
    ``(buv (R, 2, c), sel (R, c), lane_counts)``."""
    n_rows = -(-len(classes) // c)
    buv = np.zeros((n_rows, 2, c), np.int32)
    sel = np.zeros((n_rows, c), bool)
    lane_counts: List[int] = []
    for r in range(n_rows):
        chunk = classes[r * c:(r + 1) * c]
        for j, ops in enumerate(chunk):
            buv[r, :, j] = arr[:, ops[-1][0]]
            sel[r, j] = ops[-1][1]
        lane_counts.append(len(chunk))
    return buv, sel, lane_counts


# ---------------------------------------------------------------------------
# Host-facing wrapper
# ---------------------------------------------------------------------------
class DeviceGraph(substrate.BatchedStructure):
    """Device-resident dynamic graph with batched combining passes.

    Args:
      n_vertices: vertex-set size (ids are [0, n)).
      edge_capacity: fixed device edge-buffer capacity.  The host guard is
        conservative: an update batch is refused when ``live-bound +
        batch-inserts`` could exceed capacity.
      c_max: combined update-batch capacity per pass (larger batches are
        applied in c_max slices).
      n_shards, use_pallas: kept for API parity; the device picks the
        kernel path (a CUDA graph launches ``label_prop``, a CPU graph
        runs its plain version) and the vertex partition never changes
        the result.
      donate: update the state in place (default); False is the
        clone-per-pass ablation twin.
      fault_plan, guard: transactional dispatch (DESIGN.md §15).
      placement: layout of the full label rebuild (DESIGN.md §18) —
        ``None`` / ``StackedPlacement`` runs it as one launch; a
        ``MeshPlacement`` splits the edge slots across its ranks and merges
        the label tables (bit-equal: the component-min labelling is
        unique).  Updates and the contracted-graph merge stay replicated
        (``GraphState`` has no K axis to place); anything else raises
        ``TypeError``.  Every rank of the mesh builds the same graph;
        every rank then makes the same calls, or the leader (mesh index
        0) alone makes them and the others :meth:`follow` them through
        the mesh's dispatch channel (``core.placement``).
      device: ``None`` means the card (``"cuda"``) and raises without
        one; the tests pass ``"cpu"``.  Under a mesh, the rank's device.
    """

    structure = "graph"
    read_only: Set[str] = {"connected"}
    supports_megapass = True
    supports_placement = True

    def __init__(self, n_vertices: int, *, edge_capacity: int = 4096,
                 c_max: int = 64, n_shards: int = 1,
                 use_pallas: bool = False, donate: bool = True,
                 fault_plan=None, guard=None, placement=None, device=None):
        if n_vertices < 1:
            raise ValueError("n_vertices must be >= 1")
        if c_max < 1:
            raise ValueError("c_max must be >= 1")
        if edge_capacity < c_max:
            raise ValueError("edge_capacity must be >= c_max")
        self.placement = resolve_placement(placement)
        self.n = int(n_vertices)
        self.capacity = int(edge_capacity)
        self.c_max = int(c_max)
        self.n_shards = int(n_shards)
        self.use_pallas = bool(use_pallas)
        self.donate = bool(donate)
        self.device = placed_device(self.placement, device)
        self._comm = self.placement.comm()
        # host bound on the device's dirty_full: False guarantees the next
        # read pass needs no full rebuild, so a mesh skips its collective.
        # Raised by a delete lane, by inserts that could overflow the
        # pending buffer (``_pend_ub`` bounds n_pend), and by any state the
        # passes did not leave (:attr:`state`'s setter)
        self._full_possible = True
        self._pend_ub = 0
        self.state = init_state(self.n, self.capacity, self.c_max,
                                self.device)
        # live-edge-count mirror: exact after every resolved fetch; the
        # bound adds inserts whose result masks are still on the device
        self._n_edges = 0
        self._outstanding_ins = 0
        # ops answered by the host chain rule instead of a device lane
        self.eliminated_ops = 0
        self._unresolved: List[AsyncUpdateResult] = []
        # True iff an update pass ran since the last read pass — False
        # means the labels are known-current (the lean read path)
        self._maybe_stale = False
        self.fault_plan = fault_plan
        self._guard = make_guard(fault_plan, guard)
        # the yardstick seam of the read passes: only chip_smoke.py swaps
        # in the plain version, to hold the kernel pass against it on the
        # card; no entry point takes it
        self._prop: Callable = propagate

    @property
    def state(self) -> GraphState:
        return self._state

    @state.setter
    def state(self, st: GraphState) -> None:
        # the host bound follows the live dirty flag only: a state from
        # elsewhere (a restore, a clone, a caller's) may carry a rebuild
        old = self.__dict__.get("_state")
        if old is None or st.dirty_full is not old.dirty_full:
            self._full_possible = True
        self._state = st

    def _note_update(self, lane_ins: int, has_delete: bool) -> None:
        """Raise the rebuild bound for one update row's lanes."""
        self._pend_ub += lane_ins
        self._full_possible |= (has_delete or self._pend_ub
                                > self.state.pend.shape[1] - 1)

    def _take_full(self) -> bool:
        """The rebuild bound for a read pass, which clears the device's
        dirty flag and pending count: the bound restarts from zero."""
        full, self._full_possible, self._pend_ub = (
            self._full_possible, False, 0)
        return full

    # -- transactional dispatch (DESIGN.md §15) -------------------------------
    def _snapshot(self):
        """Device-side copies (the passes update the live buffers in place)
        + every host mirror the guarded thunks mutate."""
        return (clone_state(self.state), self._n_edges,
                self._outstanding_ins, self._maybe_stale)

    def _restore(self, snap) -> None:
        (self.state, self._n_edges, self._outstanding_ins,
         self._maybe_stale) = snap

    def _guarded(self, commit, site: str):
        if self._guard is None:
            return commit()
        return self._guard.run(commit, self._snapshot, self._restore,
                               site=site, channel=self.channel)

    @led
    def __len__(self) -> int:
        """Live edge count (exact: resolves any outstanding updates)."""
        self._resolve_through(None)
        return self._n_edges

    def _live_bound(self) -> int:
        return self._n_edges + self._outstanding_ins

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    # -- updates -------------------------------------------------------------
    def _edge_array(self, edges) -> np.ndarray:
        """(2, len) int32 endpoint array, vertex ids range-checked."""
        arr = np.asarray(edges, np.int64).reshape(-1, 2).T
        if arr.size and (arr.min() < 0 or arr.max() >= self.n):
            raise ValueError("vertex id out of range")
        return arr.astype(np.int32)

    @led
    def update_batch_async(self, methods: Sequence[str],
                           inputs: Sequence[Any]) -> AsyncUpdateResult:
        """Apply a combined MIXED update batch, arrival order preserved.

        The host nets the batch down to ONE lane per distinct edge class
        (its LAST op) and answers the other ops at resolve time by the
        chain rule; the lanes run as one pass per ≤ c_max row, back to
        back.  NO blocking transfer: the masks ride the next read's
        fetch.  The capacity guard covers the WHOLE batch before any
        row runs."""
        methods = list(methods)
        arr = self._edge_array(list(inputs))
        n_ops = arr.shape[1]
        if n_ops == 0:
            # nothing dispatched: the labels stay known-current
            handle = AsyncUpdateResult(self, [], 0, [], [], self.c_max)
            handle._out = []
            return handle
        classes = _classes(methods, arr)
        d = len(classes)
        self.eliminated_ops += n_ops - d
        if d == 0:                         # all self-loops: pure host
            handle = AsyncUpdateResult(self, [], n_ops, [], [], self.c_max)
            handle._resolve([])
            return handle
        lane_ins = sum(ops[-1][1] for ops in classes)
        if self._live_bound() + lane_ins > self.capacity:
            raise ValueError(
                f"edge capacity {self.capacity} exceeded: "
                f"≤{self._live_bound()} live edges "
                f"+ {lane_ins} distinct-edge inserts")
        buv, sel, lane_counts = _update_rows(classes, arr, self.c_max)

        def commit():
            # mirror mutations live inside the guarded thunk so a
            # transactional restore rewinds them with the device state
            buv_t, sel_t = self._to_device(buv), self._to_device(sel)
            if len(lane_counts) == 1:
                self.state, ok = update_pass(self.state, buv_t[0], sel_t[0],
                                             lane_counts[0],
                                             donate=self.donate)
            else:
                self.state, ok = update_rounds(self.state, buv_t, sel_t,
                                               lane_counts,
                                               donate=self.donate)
            self._outstanding_ins += lane_ins
            self._maybe_stale = True
            self._note_update(lane_ins, lane_ins < d)
            return [ok]

        masks = self._guarded(commit, "graph.update_pass")
        handle = AsyncUpdateResult(self, masks, n_ops, classes,
                                   lane_counts, self.c_max)
        self._unresolved.append(handle)
        return handle

    def _resolve_through(self, handle: Optional[AsyncUpdateResult],
                         extra=None):
        """Fetch (once) the masks of EVERY unresolved update handle plus
        ``extra``, then apply them to the mirrors in dispatch order."""
        if handle is not None and handle not in self._unresolved:
            return None                    # already resolved
        if not self._unresolved and extra is None:
            return None
        return self._fetch_through(extra)

    @led(send_args=False)
    def _fetch_through(self, extra=None):
        """The one fetch of :meth:`_resolve_through` (a follower replays
        it bare: its own handles resolve, its mirrors move alike)."""
        todo = list(self._unresolved)
        fetched = _host_fetch(([h.masks for h in todo], extra))
        for h, masks_h in zip(todo, fetched[0]):
            h._resolve(masks_h)
            self._unresolved.remove(h)
        return fetched[1]

    def occupancy_mirror(self):
        return {"n_edges": self._n_edges,
                "outstanding_ins": self._outstanding_ins}

    def insert_batch(self, edges: Sequence[Tuple[int, int]]) -> List[bool]:
        """Insert a batch of edges; per-edge "was new" results."""
        return self.update_batch(["insert"] * len(edges), edges)

    def delete_batch(self, edges: Sequence[Tuple[int, int]]) -> List[bool]:
        """Delete a batch of edges; per-edge "was present" results."""
        return self.update_batch(["delete"] * len(edges), edges)

    def insert(self, u: int, v: int) -> bool:
        return self.insert_batch([(u, v)])[0]

    def delete(self, u: int, v: int) -> bool:
        return self.delete_batch([(u, v)])[0]

    # -- reads ---------------------------------------------------------------
    @led
    def connected_batch(self, pairs: Sequence[Tuple[int, int]]) -> List[bool]:
        """Answer a batch of connectivity queries with ONE blocking fetch:
        the refresh+gather read pass when an update ran since the last
        read (its fetch also resolves every outstanding update handle),
        the lean gather/compare when the labels are known-current."""
        arr = self._edge_array(pairs)
        npairs = arr.shape[1]
        if not npairs:
            return []
        uv = self._to_device(arr)
        if not (self._maybe_stale or self._unresolved):
            ans = _connected_pairs(self.state.labels, uv)
            return np.asarray(_host_fetch(ans)).tolist()

        def commit():
            # cleared BEFORE the pass: a reentrant update re-marks it; the
            # read pass updates state in place, so it is guarded like an
            # update (a failed refresh must restore labels + dirty state)
            self._maybe_stale = False
            self.state, ans = read_pass(self.state, uv, donate=self.donate,
                                        prop=self._prop, comm=self._comm,
                                        full=self._take_full())
            return ans

        ans = self._guarded(commit, "graph.read_pass")
        got = self._resolve_through(None, extra=ans)
        return np.asarray(got).tolist()

    def connected(self, u: int, v: int) -> bool:
        return self.connected_batch([(u, v)])[0]

    @led
    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        if any(m != "connected" for m in methods):
            raise ValueError("graph reads are 'connected'")
        return self.connected_batch(inputs)

    # -- megapass (DESIGN.md §17) --------------------------------------------
    @led
    def mixed_rounds(self, rounds):
        """R heterogeneous update/read rounds as one dispatch: every
        round's rows run back to back with no host sync between them, and
        every handle shares ONE fetch (:class:`_GraphMegaFetch`).  Update
        rounds get the elimination pre-pass of ``update_batch_async``; the
        capacity guard covers the WHOLE megapass before anything runs."""
        rounds = [(kind, list(methods), list(inputs))
                  for kind, methods, inputs in rounds]
        c = self.c_max
        row_tags: List[int] = []
        row_buv: List[np.ndarray] = []
        row_flags: List[np.ndarray] = []
        row_nb: List[int] = []
        plans: List[Tuple] = []
        total_lane_ins = 0
        for kind, methods, inputs in rounds:
            if kind == "update":
                arr = self._edge_array(inputs)
                n_ops = arr.shape[1]
                classes = _classes(methods, arr)
                self.eliminated_ops += n_ops - len(classes)
                if not classes:               # empty / all self-loops
                    handle = AsyncUpdateResult(self, [], n_ops, [], [], c)
                    handle._resolve([])
                    plans.append(("done", handle))
                    continue
                total_lane_ins += sum(ops[-1][1] for ops in classes)
                buv, sel, lane_counts = _update_rows(classes, arr, c)
                row_lo = len(row_tags)
                row_tags += [MEGA_UPDATE] * len(lane_counts)
                row_buv += list(buv)
                row_flags += list(sel)
                row_nb += lane_counts
                inner = AsyncUpdateResult(self, [], n_ops, classes,
                                          lane_counts, c)
                plans.append(("update", row_lo, len(row_tags), inner))
            elif kind == "read":
                if any(m != "connected" for m in methods):
                    raise ValueError("graph read rounds take 'connected'")
                arr = self._edge_array(inputs)
                npairs = arr.shape[1]
                if npairs == 0:
                    plans.append(("done", substrate._DoneReads([])))
                    continue
                row_lo = len(row_tags)
                counts: List[int] = []
                for r in range(-(-npairs // c)):
                    chunk = arr[:, r * c:(r + 1) * c]
                    uv = np.zeros((2, c), np.int32)
                    uv[:, :chunk.shape[1]] = chunk
                    row_tags.append(MEGA_READ)
                    row_buv.append(uv)
                    row_flags.append(np.zeros((c,), bool))
                    row_nb.append(chunk.shape[1])
                    counts.append(chunk.shape[1])
                plans.append(("read", row_lo, counts))
            else:
                raise ValueError(f"unknown round kind {kind!r} "
                                 f"(want 'update' or 'read')")
        # whole-megapass capacity guard, BEFORE any dispatch
        if self._live_bound() + total_lane_ins > self.capacity:
            raise ValueError(
                f"edge capacity {self.capacity} exceeded: "
                f"≤{self._live_bound()} live edges "
                f"+ {total_lane_ins} distinct-edge inserts (megapass)")
        if not row_tags:                      # nothing dispatches
            return [p[1] for p in plans]
        # staleness after the pass: an update row after the last read row
        # leaves the labels stale
        has_read = MEGA_READ in row_tags
        last_read = max((i for i, t in enumerate(row_tags)
                         if t == MEGA_READ), default=-1)
        upd_after = MEGA_UPDATE in row_tags[last_read + 1:]
        buv_all, flags_all = np.stack(row_buv), np.stack(row_flags)

        def commit():
            self._outstanding_ins += total_lane_ins
            self._maybe_stale = (upd_after if has_read
                                 else self._maybe_stale or upd_after)
            full = []
            for tag, sel, k in zip(row_tags, row_flags, row_nb):
                if tag == MEGA_READ:
                    full.append(self._take_full())
                else:
                    full.append(False)
                    self._note_update(int(sel[:k].sum()), not sel[:k].all())
            self.state, oks = mixed_rounds_pass(
                self.state, row_tags, self._to_device(buv_all),
                self._to_device(flags_all), row_nb, donate=self.donate,
                prop=self._prop, comm=self._comm, full=full)
            return oks

        oks = self._guarded(commit, "graph.mixed_rounds")
        shared = _GraphMegaFetch(self, oks)
        handles: List[Any] = []
        for plan in plans:
            if plan[0] == "done":
                handles.append(plan[1])
            elif plan[0] == "update":
                _, lo, hi, inner = plan
                shared._upd.append((inner, lo, hi))
                handles.append(_MegaUpdateHandle(shared, inner))
            else:
                _, lo, counts = plan
                handles.append(_GraphReadRound(shared, lo, counts))
        return handles

    # -- debug / test helpers -------------------------------------------------
    def global_state(self) -> GraphState:
        """The state every rank holds (replicated under a mesh)."""
        return self.state

    def full_rebuilds(self) -> int:
        """Device-side full-rebuild counter (insert-only traffic must not
        bump it: the union-find fast path takes it)."""
        return int(self.state.n_full)

    def fast_merges(self) -> int:
        """Device-side count of read passes that took the fast path."""
        return int(self.state.n_fast)

    def edges(self) -> Set[Tuple[int, int]]:
        """Host copy of the live edge set (test/debug; one fetch)."""
        eu, ev, valid = _host_fetch((self.state.eu, self.state.ev,
                                     self.state.valid))
        live = np.asarray(valid, bool)
        return set(zip(np.asarray(eu)[live].tolist(),
                       np.asarray(ev)[live].tolist()))

    def labels(self) -> List[int]:
        """Host copy of the device labels, refreshed first (one read pass
        when stale, then one fetch)."""
        if self._maybe_stale or self._unresolved:
            self.connected_batch([(0, 0)])
        return np.asarray(_host_fetch(self.state.labels)).tolist()


# ---------------------------------------------------------------------------
# Registration (DESIGN.md §16)
# ---------------------------------------------------------------------------
from . import read_opt as _read_opt  # noqa: E402
from .dynamic_graph import DynamicGraph as _DynamicGraph  # noqa: E402

_N_DEFAULT = 24


def _gen_update(rng, k, ctx):
    """Pool-biased edge batches: 60% revisit a known edge (deletes and
    duplicate inserts actually collide), insert/delete at 65/35."""
    pool = ctx.setdefault("edges", [])
    n = ctx.get("n", _N_DEFAULT)
    methods, inputs = [], []
    for _ in range(k):
        if pool and rng.random() < 0.6:
            u, v = pool[int(rng.integers(len(pool)))]
        else:
            u = int(rng.integers(n))
            v = int(rng.integers(n))
            pool.append((u, v))
        methods.append("insert" if rng.random() < 0.65 else "delete")
        inputs.append((u, v))
    return methods, inputs


def _gen_read(rng, k, ctx):
    n = ctx.get("n", _N_DEFAULT)
    return (["connected"] * k,
            [(int(rng.integers(n)), int(rng.integers(n)))
             for _ in range(k)])


def _refusal_batch(ds: DeviceGraph):
    """capacity + 1 distinct fresh edge classes: the whole-batch edge
    bound must refuse before any slice dispatches."""
    need = ds.capacity + 1
    pairs = [(u, v) for u in range(ds.n) for v in range(u + 1, ds.n)]
    if len(pairs) < need:
        raise ValueError("vertex count too small for the refusal probe")
    return (["insert"] * need, pairs[:need])


def _make(n: int = _N_DEFAULT, edge_capacity: int = 256, c_max: int = 8,
          n_shards: int = 2, **kw) -> DeviceGraph:
    return DeviceGraph(n, edge_capacity=edge_capacity, c_max=c_max,
                       n_shards=n_shards, **kw)


def _make_host(ds: DeviceGraph) -> _DynamicGraph:
    host = _DynamicGraph(ds.n, device=ds.device)
    for u, v in sorted(ds.edges()):
        host.insert(u, v)
    return host


def _edge_set(obj):
    edges = obj.edges() if callable(obj.edges) else obj.edges
    return {(min(u, v), max(u, v)) for u, v in edges}


def _dump_compare(ds: DeviceGraph, oracle) -> None:
    got, want = _edge_set(ds), _edge_set(oracle)
    assert got == want, (sorted(got), sorted(want))


substrate.register(substrate.StructureSpec(
    name="graph",
    module="repro_torch.core.device_graph",
    title="dynamic connectivity graph",
    make=_make,
    make_host=_make_host,
    gen_update=_gen_update,
    gen_read=_gen_read,
    new_ctx=lambda: {"n": _N_DEFAULT},
    dump_compare=_dump_compare,
    compact=_read_opt._compact_graph,
    refusal_batch=_refusal_batch,
    megapass=True,
    extras={"serve_kw": dict(c_max=64, n_shards=4),
            # the constructor takes placement= (DESIGN.md §18); serve.py
            # keys --mesh-shards off this marker
            "placement": True},
))
