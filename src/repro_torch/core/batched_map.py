"""Device-resident batched ordered map (DESIGN.md §13) — the flagship
structure of the batch-parallel literature (Lim's 2-3 trees).

The port of ``repro.core.batched_map``.  Each shard is a **flat 2-3
tree**: a fixed-capacity sorted unique-key array (keys ascending in
``[0, size)``, ``(+inf, +inf)`` padding beyond, one scratch slot for
predicated scatters).  Sorted order makes every read a vectorized search
and one combining pass of mixed updates a **sort-merge**:

* **apply pass** — applies a ≤ ``c_max`` MIXED insert/delete/assign batch
  with sequential arrival-order semantics.  Per-lane results follow the
  last-earlier-same-key chain rule; the array takes only the NET effect
  per key class: deletions become a ``keep`` mask, insertions a short
  sorted run, value rewrites scatter at their slot, and one
  **merge-compact** (``kernels/sorted_merge``) rebuilds every shard — the
  hand-written kernel on the card, its plain version on the CPU.
* **read pass** — ``lookup``, ``range_count``, ``range_sum`` (closed
  interval [lo, hi]) and ``kth_smallest`` for a whole read batch: binary
  search against the sorted rows, prefix sums for range aggregation, a
  shard-size cumsum for the global k-th.  Reads never mutate state.
* **rounds** (DESIGN.md §12) — update batches wider than ``c_max`` run as
  R passes back to back on one stream; the result masks stay on the
  device and ride the next read's single blocking fetch
  (``update_batch_async`` — the one-sync contract, DESIGN.md §10/§11).
* **key-range sharding** — ``ShardedMap`` stacks K shards on a leading
  axis and routes every op by the Lim-style key-range partition
  (``sharded_pq.route_range`` and its bit-exact host twin), so shard
  concatenation stays globally sorted; the sync-free host occupancy
  guard refuses overflowing batches **atomically** (a refused batch
  leaves the device buffers and the host mirror untouched).
* **placement** (DESIGN.md §18) — under a ``MeshPlacement`` each rank
  holds its K / D shard rows: routing runs replicated against global
  shard ids, the net-effect prep and ``sorted_merge`` run on the local
  rows, the arrival-order results and the read pass's per-shard stats are
  all-gathered into the stacked (K, ·) order (so even ``range_sum``'s
  float sums are the stacked pass's bit for bit), and the global k-th key
  is an all-reduce MIN to which only the owning rank gives a finite key.

The merge reads the old rows while it writes the new ones, so it cannot
run in place: each apply pass writes a fresh ``(K, capacity + 1)`` row
block (the caching allocator hands back the one the previous pass freed)
and drops the old one — the port's form of the reference's donation.
The value rewrites of a pass land in the old rows in place first, so
``donate=False`` (the copy-per-pass ablation twin) clones the state
before the pass.  Nothing on a pass reads the device from the host: the
shard sizes and the merge's ``b_count`` stay on the card.

Differences from the reference that change no result: the searches run
over the whole ``capacity + 1`` row (its scratch slot is +inf, like the
padding), the round count and the query width are not padded to powers
of two (a loop of passes has no jit cache), and ``_init_state``
quantizes and deduplicates its items with numpy in O(n log n).  The
wrapper is not thread-safe; the read-optimized combiner serializes it.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, List, NamedTuple, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from ..kernels.sorted_merge import merge_compact_sharded
from . import substrate
from .batched_pq import INF, _TINY, _device_get, _flush_subnormals
from .faults import make_guard
from .placement import STACKED, led, placed_device, resolve_placement
from .sharded_pq import _route, _route_host, host_key

# All device→host transfers on the map hot path route through this hook
# so tests can count blocking syncs (same idiom as batched_pq._host_fetch).
_host_fetch = _device_get

OP_INSERT, OP_DELETE, OP_ASSIGN = 0, 1, 2
RD_LOOKUP, RD_COUNT, RD_SUM, RD_KTH = 0, 1, 2, 3

_UPDATE_CODE = {"insert": OP_INSERT, "delete": OP_DELETE,
                "assign": OP_ASSIGN}
_READ_CODE = {"lookup": RD_LOOKUP, "range_count": RD_COUNT,
              "range_sum": RD_SUM, "kth_smallest": RD_KTH}


def _qkey(x: float) -> float:
    """The exact f32 key the device map stores (f32 + flush-to-zero,
    DESIGN.md §7).  ±inf is the padding sentinel and NaN breaks the
    binary search, so both are rejected at this host boundary."""
    k = float(np.float32(x))
    if math.isnan(k) or math.isinf(k):
        raise ValueError("map keys must be finite f32: ±inf is the "
                         "padding sentinel and NaN breaks the search")
    return host_key(k)


def _qval(x: float) -> float:
    """Values are stored as f32; NaN is rejected (the merge moves values
    but its preconditions exclude NaN payloads)."""
    v = float(np.float32(x))
    if math.isnan(v):
        raise ValueError("map values must not be NaN")
    return v


class MapState(NamedTuple):
    """K sorted-array shards stacked on the leading axis.

    Index ``capacity`` of every row is the SCRATCH slot for predicated
    scatters (the graph/heap idiom): inactive lanes write there with one
    fixed payload, so they can never collide with an active write."""

    keys: torch.Tensor   # (K, capacity+1) f32 ascending in [0,size), +inf pad
    vals: torch.Tensor   # (K, capacity+1) f32, +inf past size
    size: torch.Tensor   # (K,) int32


def clone_state(state):
    return type(state)(*(t.clone() for t in state))


def _fresh_rows(like: torch.Tensor) -> torch.Tensor:
    """An uninitialized row block shaped like ``like`` with its scratch
    column set to +inf; the merge writes every body slot."""
    rows = torch.empty_like(like)
    rows[:, -1:].fill_(INF)
    return rows


def _route_rows(k: torch.Tensor, payloads, nb: int, K: int,
                key_range: Optional[Tuple[float, float]]):
    """Route the ≤ c live lanes to their shard rows, lane order preserved
    within each row (load-bearing for the chain rule).  Returns ``(rows
    (one (K, c) tensor per ``(payload, fill)``), lanes per shard (K,),
    shard_of (c,), rank (K, c))``; empty lanes of a row hold the fill."""
    c = k.shape[0]
    dev = k.device
    lane = torch.arange(c, device=dev)
    active = lane < nb
    shard_of = torch.where(active, _route(k, K, key_range), 0).long()
    one_hot = ((shard_of[None, :] == torch.arange(K, device=dev)[:, None])
               & active[None, :])                         # (K, c)
    rank = torch.cumsum(one_hot, 1) - 1
    counts = one_hot.sum(1)
    dest = torch.where(one_hot, rank, c)                  # scratch col c
    rows = []
    for payload, fill in payloads:
        row = torch.full((K, c + 1), fill, dtype=payload.dtype, device=dev)
        row.scatter_(1, dest, torch.where(one_hot, payload[None, :], fill))
        rows.append(row[:, :c].contiguous())
    return rows, counts, shard_of, rank


def _lane_results(ok_rows: torch.Tensor, shard_of: torch.Tensor,
                  rank: torch.Tensor, nb: int) -> torch.Tensor:
    """Per-lane row results gathered back into arrival order."""
    c = shard_of.shape[0]
    lane = torch.arange(c, device=shard_of.device)
    return (lane < nb) & ok_rows[shard_of,
                                 rank[shard_of, lane].clamp(0, c - 1)]


def _search(keys: torch.Tensor, q: torch.Tensor, size: torch.Tensor):
    """Masked binary search of (K, q) keys in the sorted rows: ``(pos,
    pos clipped into the body, found)``.  The whole row is searched: its
    scratch slot is +inf like the padding, so ``pos`` equals the
    reference's search of the body for every finite or +inf query."""
    cap = keys.shape[1] - 1
    pos = torch.searchsorted(keys, q, side="left")
    pos_c = pos.clamp(0, cap - 1)
    found = (pos < size[:, None]) & (keys.gather(1, pos_c) == q)
    return pos, pos_c, found


# ---------------------------------------------------------------------------
# Mixed-op apply pass — net-effect sort-merge
# ---------------------------------------------------------------------------
def _prep(keys, vals, size, k1, v1, code1, nb1):
    """Net every shard's ≤ c op row down to merge-compact inputs (the
    reference's ``_prep_one``, over the shard axis).

    ``k1``/``v1``/``code1``: (K, c) rows; ``nb1``: (K,) live lanes.
    Rewrites values of surviving keys in ``vals`` IN PLACE and returns
    ``(keep, b_keys, b_vals, b_count, new_size, ok)``: the survivor mask
    over the body, the sorted run of netted-in pairs and the per-lane
    arrival-order results."""
    K, c = k1.shape
    cap = keys.shape[1] - 1
    dev = keys.device
    lane = torch.arange(c, device=dev)
    active = lane[None, :] < nb1[:, None]
    is_ins = active & (code1 == OP_INSERT)
    is_del = active & (code1 == OP_DELETE)
    is_asn = active & (code1 == OP_ASSIGN)

    pos, pos_c, in_map0 = _search(keys, k1, size)
    stored = vals.gather(1, pos_c)                        # junk unless in_map0

    # arrival-order chain rule: a lane's key is "present before" iff the
    # LAST earlier presence-changing lane on the same key was an insert
    same = ((k1[:, :, None] == k1[:, None, :])
            & active[:, :, None] & active[:, None, :])    # (K, c, c)
    before = lane[None, :] < lane[:, None]                # [i, j]: j < i
    pchg = is_ins | is_del

    def last(mask):                     # (any, index of the last j in mask)
        return mask.any(2), torch.where(mask, lane, -1).argmax(2)

    has_prev, prev = last(same & pchg[:, None, :] & before)
    present_before = torch.where(has_prev, is_ins.gather(1, prev), in_map0)
    ok = active & torch.where(is_ins, ~present_before, present_before)

    # net effect per key class: the last presence-changing lane decides
    # final presence; the last EFFECTIVE write decides the final value
    has_pchg, last_p = last(same & pchg[:, None, :])
    final_present = torch.where(has_pchg, is_ins.gather(1, last_p), in_map0)
    wr = (is_ins & ~present_before) | (is_asn & present_before)
    has_wr, last_wr = last(same & wr[:, None, :])
    final_val = torch.where(has_wr, v1.gather(1, last_wr), stored)

    # one representative lane per class carries the buffer effect
    is_rep = active & ~(same & before).any(2)
    rem = is_rep & in_map0 & ~final_present               # netted out
    upd = is_rep & in_map0 & final_present & has_wr       # value rewrite
    add = is_rep & ~in_map0 & final_present               # netted in

    # in-place value rewrites at the exact slot (predicated scatter)
    tgt = torch.where(upd, pos, cap)
    vals.scatter_(1, tgt, torch.where(upd, final_val, vals.gather(1, tgt)))

    # deletions become the merge's keep mask
    rflag = torch.zeros((K, cap + 1), dtype=torch.bool, device=dev)
    rflag.scatter_(1, torch.where(rem, pos, cap), rem)
    keep = ((torch.arange(cap, device=dev)[None, :] < size[:, None])
            & ~rflag[:, :cap])

    # insertions become the sorted b-run (stable argsort; distinct keys)
    bkey_raw = torch.where(add, k1, INF)
    order = torch.argsort(bkey_raw, dim=1, stable=True)
    b_keys = bkey_raw.gather(1, order)
    b_vals = torch.where(add, final_val, INF).gather(1, order)
    b_count = add.sum(1, dtype=torch.int32)
    new_size = size - rem.sum(1, dtype=torch.int32) + b_count
    return keep, b_keys, b_vals, b_count, new_size, ok


def _apply_impl(state: MapState, op_keys: torch.Tensor,
                op_vals: torch.Tensor, op_code: torch.Tensor, nb: int, *,
                key_range: Optional[Tuple[float, float]] = None,
                merge: Callable = merge_compact_sharded, comm=STACKED
                ) -> Tuple[MapState, torch.Tensor]:
    """Apply ≤ c MIXED insert/delete/assign ops as ONE pass.

    ``op_keys``/``op_vals``: (c,) f32; ``op_code``: (c,) int32
    (0=insert, 1=delete, 2=assign); ``nb``: live lane count (host int).
    Returns ``(state, ok (c,) bool)`` with the per-lane arrival-order
    results left on the device.  The value rewrites land in ``state``'s
    rows in place; the merged rows are a new block.

    ``merge`` is the yardstick seam: no entry point passes it, and only
    ``chip_smoke.py`` swaps in ``merge_compact_plain`` to hold the kernel
    pass against the plain pass on the card.

    ``comm``: the placement's collectives.  Under a mesh, ``state`` holds
    this rank's K / D rows: the lanes route against global shard ids, the
    prep and the merge run on the local rows, and the per-lane results
    are all-gathered back into the stacked (K, c) order."""
    keys, vals, size = state
    K_local = keys.shape[0]
    K = K_local * comm.n
    mine = slice(comm.index * K_local, (comm.index + 1) * K_local)
    cap = keys.shape[1] - 1
    k = _flush_subnormals(op_keys.to(torch.float32))
    v = op_vals.to(torch.float32)
    (rows_k, rows_v, rows_c), counts, shard_of, rank = _route_rows(
        k, [(k, INF), (v, 0.0), (op_code, 0)], nb, K, key_range)
    keep, b_keys, b_vals, b_count, new_size, ok_rows = _prep(
        keys, vals, size, rows_k[mine], rows_v[mine], rows_c[mine],
        counts[mine])
    new_keys, new_vals = _fresh_rows(keys), _fresh_rows(vals)
    merge(keys[:, :cap], vals[:, :cap], keep, b_keys, b_vals, b_count,
          out=(new_keys[:, :cap], new_vals[:, :cap]))
    return (MapState(new_keys, new_vals, new_size),
            _lane_results(comm.gather(ok_rows), shard_of, rank, nb))


def apply_rounds(state: MapState, op_keys, op_vals, op_code,
                 nb: Sequence[int], *, key_range=None, donate: bool = True,
                 merge: Callable = merge_compact_sharded, comm=STACKED):
    """R sequential ≤ c slices back to back on one stream (DESIGN.md
    §12): ``op_keys``/``op_vals``/``op_code`` (R, c), ``nb`` R host ints.
    Returns ``(state, oks (R, c))``; no host sync between the slices.
    ``donate=False`` runs on a clone and leaves ``state`` untouched."""
    if not donate:
        state = clone_state(state)
    oks = []
    for r, n in enumerate(nb):
        state, ok = _apply_impl(state, op_keys[r], op_vals[r], op_code[r],
                                n, key_range=key_range, merge=merge,
                                comm=comm)
        oks.append(ok)
    return state, torch.stack(oks)


# ---------------------------------------------------------------------------
# Vectorized read pass (reads copy nothing)
# ---------------------------------------------------------------------------
def _read_impl(state: MapState, qa: torch.Tensor, qb: torch.Tensor,
               qkind: torch.Tensor, comm=STACKED
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Answer a mixed read batch in one pass, on the device.

    ``qa``/``qb``: (q,) f32 — the key (lookup), [lo, hi] bounds
    (range_count / range_sum) or k (kth_smallest, in ``qa``);
    ``qkind``: (q,) int32.  Returns ``(res (q,) f32, ok (q,) bool)`` —
    ``ok`` is the found/in-range flag for lookup and kth_smallest.
    ``range_sum`` is a difference of f32 prefix sums, as in the
    reference, so its last bits depend on the summation order.

    ``comm``: under a mesh the per-shard searches and prefix sums run on
    this rank's rows, their (K / D, q) stats are all-gathered into the
    stacked (K, q) order and reduced by the stacked code, and the k-th
    key is an all-reduce MIN over the ranks, only the owner finite."""
    keys, vals, size = state
    K_local = keys.shape[0]
    K = K_local * comm.n
    base = comm.index * K_local
    cap = keys.shape[1] - 1
    dev = keys.device
    q = qa.shape[0]
    qa = _flush_subnormals(qa.to(torch.float32))
    qb = _flush_subnormals(qb.to(torch.float32))
    qa_k = qa[None, :].expand(K_local, q).contiguous()
    qb_k = qb[None, :].expand(K_local, q).contiguous()
    sz = size[:, None].long()

    pos, pos_c, found = _search(keys, qa_k, size)
    lval = torch.where(found, vals.gather(1, pos_c), INF)
    # closed-interval rank bounds
    lo = torch.minimum(pos, sz)
    hi = torch.minimum(torch.searchsorted(keys, qb_k, side="right"), sz)
    cnt = (hi - lo).clamp(min=0)
    # prefix sums of the live values for range aggregation
    live = torch.where(torch.arange(cap, device=dev)[None, :] < sz,
                       vals[:, :cap], 0.0)
    ps = torch.cat([torch.zeros((K_local, 1), dtype=torch.float32,
                                device=dev),
                    torch.cumsum(live, 1)], 1)
    rsum = torch.where(hi > lo, ps.gather(1, hi) - ps.gather(1, lo), 0.0)
    found, lval, cnt, rsum = (comm.gather(t) for t in (found, lval, cnt,
                                                       rsum))
    size_g = comm.gather(size)

    any_found = found.any(0)
    # exactly one shard can hold the key (routing) — masked min IS select
    look_val = torch.where(found, lval, INF).min(0).values
    total_cnt = cnt.sum(0).to(torch.float32)
    total_sum = rsum.sum(0)

    # global k-th: key-range routing keeps the shard concatenation
    # globally sorted, so a cumulative-size search finds the owner shard
    ccum = torch.cumsum(size_g.long(), 0)
    kq = qa.to(torch.int32).long()
    sh = (ccum[:, None] < kq[None, :]).sum(0)
    sh_c = sh.clamp(0, K - 1)
    prior = torch.where(sh > 0, ccum[(sh - 1).clamp(0, K - 1)], 0)
    loc = kq - prior
    kth_ok = (kq >= 1) & (kq <= ccum[K - 1])
    # only the owner rank's key is finite (stacked: every shard is owned)
    owner = (sh_c >= base) & (sh_c < base + K_local)
    kth_val = comm.min(torch.where(
        owner, keys[(sh_c - base).clamp(0, K_local - 1),
                    (loc - 1).clamp(0, cap - 1)], INF))

    res = torch.where(
        qkind == RD_LOOKUP, look_val,
        torch.where(qkind == RD_COUNT, total_cnt,
                    torch.where(qkind == RD_SUM, total_sum, kth_val)))
    ok = torch.where(qkind == RD_LOOKUP, any_found,
                     (qkind != RD_KTH) | kth_ok)
    return res, ok


# ---------------------------------------------------------------------------
# Mixed update+read megapass (DESIGN.md §17)
# ---------------------------------------------------------------------------
MEGA_UPDATE, MEGA_READ = 0, 1


def mixed_rounds_pass(state: MapState, tags: Sequence[int], op_a, op_b,
                      op_code, nb: Sequence[int], *, key_range=None,
                      donate: bool = True,
                      merge: Callable = merge_compact_sharded, comm=STACKED):
    """R heterogeneous rounds back to back with no host sync between them.

    Row payloads share lanes: ``op_a``/``op_b`` (R, c) f32 carry (keys,
    vals) for updates and (qa, qb) for reads; ``op_code`` (R, c) int32
    the op code or the read kind; ``nb`` R host ints.  Returns ``(state,
    res (R, c), ok (R, c))``: update rows fill ``res`` with +inf and
    ``ok`` with their arrival-order masks; read rows answer all c lanes
    (the host masks) and leave the state untouched."""
    if not donate:
        state = clone_state(state)
    res, oks = [], []
    for r, tag in enumerate(tags):
        if tag == MEGA_READ:
            got, ok = _read_impl(state, op_a[r], op_b[r], op_code[r],
                                 comm=comm)
        else:
            state, ok = _apply_impl(state, op_a[r], op_b[r], op_code[r],
                                    nb[r], key_range=key_range, merge=merge,
                                    comm=comm)
            got = torch.full_like(op_a[r], INF)
        res.append(got)
        oks.append(ok)
    return state, torch.stack(res), torch.stack(oks)


def _encode_update_ops(methods: Sequence[str], inputs: Sequence[Any]):
    """Validate + quantize an update op list into (opk, opv, code) f32/
    f32/int32 arrays — raises ``ValueError`` before anything dispatches."""
    n_ops = len(methods)
    opk = np.zeros((n_ops,), np.float32)
    opv = np.zeros((n_ops,), np.float32)
    code = np.zeros((n_ops,), np.int32)
    for i, (m, inp) in enumerate(zip(methods, inputs)):
        if m not in _UPDATE_CODE:
            raise ValueError(f"unknown update method {m!r}")
        code[i] = _UPDATE_CODE[m]
        if m == "delete":
            opk[i] = _qkey(inp)
        else:
            opk[i] = _qkey(inp[0])
            opv[i] = _qval(inp[1])
    return opk, opv, code


def _encode_read_ops(methods: Sequence[str], inputs: Sequence[Any]):
    """Validate + quantize a read op list into (qa, qb, kind) arrays."""
    n = len(methods)
    qa = np.zeros((n,), np.float32)
    qb = np.full((n,), -1.0, np.float32)
    kind = np.full((n,), RD_COUNT, np.int32)
    for i, (m, inp) in enumerate(zip(methods, inputs)):
        if m not in _READ_CODE:
            raise ValueError(f"unknown read method {m!r}")
        kind[i] = _READ_CODE[m]
        if m == "lookup":
            qa[i] = _qkey(inp)
        elif m == "kth_smallest":
            qa[i] = np.float32(int(inp))
        else:
            qa[i] = _qkey(inp[0])
            qb[i] = _qkey(inp[1])
    return qa, qb, kind


def _convert_read_results(methods: Sequence[str], res_h, ok_h) -> List[Any]:
    """Fetched (res, ok) lanes → per-op python results, arrival order."""
    out: List[Any] = []
    for i, m in enumerate(methods):
        if m == "range_count":
            out.append(int(res_h[i]))
        elif m == "range_sum":
            out.append(float(res_h[i]))
        else:                          # lookup / kth_smallest
            out.append(float(res_h[i]) if ok_h[i] else None)
    return out


def _pack_rows(cols, n: int, c: int, fills):
    """Cut ``n`` ops into ⌈n / c⌉ rows of c lanes: one (R, c) array per
    column, empty lanes holding the column's fill; plus the live lanes
    per row."""
    n_rows = -(-n // c)
    out = []
    for col, fill in zip(cols, fills):
        a = np.full((n_rows * c,), fill, col.dtype)
        a[:n] = col
        out.append(a.reshape(n_rows, c))
    return out, [min(c, n - r * c) for r in range(n_rows)]


# ---------------------------------------------------------------------------
# Deferred update results (the one-sync contract, DESIGN.md §10/§11)
# ---------------------------------------------------------------------------
class AsyncMapUpdate:
    """Deferred host view of one update batch's per-op results.

    The ok masks stay on the device until the first :meth:`result` call
    — or, cheaper, until the owning map's next ``read_batch`` fetches them
    inside its single blocking transfer.  Resolution also re-tightens the
    owner's occupancy mirror to the exact shard sizes."""

    def __init__(self, owner, masks: List[torch.Tensor],
                 lane_counts: List[int], c_max: int):
        self._owner = owner
        self.masks = masks
        self._lane_counts = lane_counts
        self._c_max = c_max
        self._out: Optional[List[bool]] = None

    def _resolve(self, masks_h) -> None:
        if masks_h and self._lane_counts:
            rows = np.concatenate(
                [np.asarray(m).reshape(-1, self._c_max) for m in masks_h],
                axis=0)
            out = np.concatenate(
                [rows[r, :nc] for r, nc in enumerate(self._lane_counts)])
        else:
            out = np.zeros((0,), bool)
        self._out = [bool(x) for x in out]
        self._owner = None
        self.masks = []

    def result(self) -> List[bool]:
        """Per-op results in arrival order (cached after first call)."""
        if self._out is None:
            self._owner._resolve_through(self)
        return self._out


class _MegapassFetch:
    """The ONE deferred blocking fetch shared by every handle of a
    megapass dispatch (DESIGN.md §17): the first handle resolved fetches
    the (R, c) result rows together with every OLDER outstanding update
    handle and the exact shard sizes."""

    def __init__(self, owner, res_rows, ok_rows):
        self._owner = owner
        self._res = res_rows
        self._ok = ok_rows
        self._upd: List[Tuple[AsyncMapUpdate, int, int]] = []
        self._cache = None

    def rows(self):
        if self._cache is None:
            got = self._owner._resolve_through(
                None, extra=(self._res, self._ok))
            res_h, ok_h = np.asarray(got[0]), np.asarray(got[1])
            for inner, lo, hi in self._upd:
                if inner._out is None:
                    inner._resolve([ok_h[lo:hi]])
            self._cache = (res_h, ok_h)
            self._owner = self._res = self._ok = None
            self._upd = []
        return self._cache


class _MegaUpdateRound:
    """Handle for one update round of a megapass: per-op ok masks in
    arrival order, resolved through the dispatch's shared fetch."""

    def __init__(self, shared: _MegapassFetch, inner: AsyncMapUpdate):
        self._shared = shared
        self._inner = inner

    def result(self) -> List[bool]:
        if self._inner._out is None:
            self._shared.rows()
        return self._inner._out


class _MegaReadRound:
    """Handle for one read round of a megapass."""

    def __init__(self, shared: _MegapassFetch, row_lo: int,
                 counts: List[int], methods: List[str]):
        self._shared = shared
        self._row_lo = row_lo
        self._counts = counts
        self._methods = methods

    def result(self) -> List[Any]:
        res_h, ok_h = self._shared.rows()
        rows = range(self._row_lo, self._row_lo + len(self._counts))
        res = np.concatenate([res_h[r, :nc]
                              for r, nc in zip(rows, self._counts)])
        ok = np.concatenate([ok_h[r, :nc]
                             for r, nc in zip(rows, self._counts)])
        return _convert_read_results(self._methods, res, ok)


# ---------------------------------------------------------------------------
# Host-facing wrappers
# ---------------------------------------------------------------------------
class ShardedMap(substrate.BatchedStructure):
    """K-sharded device-resident ordered map with combining passes.

    Args:
      capacity: per-shard slot capacity (plus one scratch slot).
      c_max: combined update-batch capacity per pass (larger batches run
        as back-to-back passes).
      n_shards: shard count K.  K > 1 requires ``key_range``.
      key_range: (lo, hi) — the Lim-style key-range partition
        (``sharded_pq.route_range``); keys outside clamp to the edge
        shards, so the shard concatenation stays globally sorted.
      items: optional initial (key, value) pairs (last write wins).
      use_pallas: kept for API parity; the device picks the merge path (a
        CUDA map launches ``sorted_merge``, a CPU map runs its plain
        version).
      donate: rebuild in place of the old rows (default); ``False`` is
        the copy-per-pass ablation twin.
      fault_plan, guard: transactional dispatch (DESIGN.md §15).
      placement: shard layout (DESIGN.md §18) — ``None`` /
        ``StackedPlacement`` keeps all K rows in this process; a
        ``MeshPlacement`` (K % D == 0) keeps this rank's K / D rows on its
        device and runs the cross-shard steps as collectives over a
        process group of the map's own.  Every rank of the mesh builds
        the same map; every rank then makes the same calls, or the leader
        (mesh index 0) alone makes them and the others :meth:`follow`
        them through the mesh's dispatch channel (``core.placement``).
        Anything else raises ``TypeError``.
      device: ``None`` means the card (``"cuda"``) and raises without
        one; the tests pass ``"cpu"``.  Under a mesh, the rank's device.

    Sync-free occupancy guard (DESIGN.md §10): the wrapper mirrors the
    device's key-range routing on the host (bit exact) and keeps
    per-shard occupancy upper bounds — inserts grow the bound at
    dispatch, the bound re-tightens to the true sizes at every consumed
    fetch.  The guard is ATOMIC across the slices of one batch.
    """

    structure = "map"
    read_only: Set[str] = {"lookup", "range_count", "range_sum",
                           "kth_smallest"}
    supports_megapass = True
    supports_placement = True

    def __init__(self, capacity: int, c_max: int, n_shards: int = 1,
                 key_range: Optional[Tuple[float, float]] = None,
                 items=None, use_pallas: bool = False,
                 donate: bool = True, fault_plan=None, guard=None,
                 placement=None, device=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if c_max < 1:
            raise ValueError("c_max must be >= 1")
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if n_shards > 1 and key_range is None:
            raise ValueError(
                "n_shards > 1 requires key_range: the ordered reads "
                "(kth_smallest) need the key-range partition")
        self.placement = resolve_placement(placement)
        self.placement.validate(int(n_shards))
        self.capacity = int(capacity)
        self.c_max = int(c_max)
        self.n_shards = int(n_shards)
        self.use_pallas = bool(use_pallas)
        self.donate = bool(donate)
        self.device = placed_device(self.placement, device)
        self._comm = self.placement.comm()
        self.key_range = ((float(key_range[0]), float(key_range[1]))
                          if key_range is not None else None)
        self.fault_plan = fault_plan
        self._guard = make_guard(fault_plan, guard)
        self.state = self._init_state(items)
        self._unresolved: List[AsyncMapUpdate] = []
        # the yardstick seam of the apply passes: only chip_smoke.py swaps
        # in the plain merge, to hold the kernel pass against it on the
        # card; no entry point takes it
        self._merge: Callable = merge_compact_sharded

    # -- transactional dispatch (DESIGN.md §15) -------------------------------
    def _snapshot(self):
        """Device-side copies (a pass rewrites values in place) + the
        occupancy mirror."""
        return clone_state(self.state), self._sizes_ub.copy()

    def _restore(self, snap) -> None:
        self.state, self._sizes_ub = snap

    def _guarded(self, commit, site: str):
        if self._guard is None:
            return commit()
        return self._guard.run(commit, self._snapshot, self._restore,
                               site=site, channel=self.channel)

    def _init_state(self, items) -> MapState:
        K, cap = self.n_shards, self.capacity
        keys = np.full((K, cap + 1), np.inf, np.float32)
        vals = np.full((K, cap + 1), np.inf, np.float32)
        size = np.zeros((K,), np.int32)
        items = list(items) if items else []
        if items:
            ks = np.asarray([k for k, _ in items], np.float32)
            vs = np.asarray([v for _, v in items], np.float32)
            if not np.all(np.isfinite(ks)):
                raise ValueError("map keys must be finite f32: ±inf is the "
                                 "padding sentinel and NaN breaks the "
                                 "search")
            if np.any(np.isnan(vs)):
                raise ValueError("map values must not be NaN")
            ks = np.where(np.abs(ks) < _TINY, np.float32(0.0), ks)
            # last write wins: the first occurrence in the reversed list
            ks, first = np.unique(ks[::-1], return_index=True)
            vs = vs[::-1][first]
            shards = _route_host(ks, K, self.key_range)
            for k in range(K):
                mine = shards == k
                n = int(mine.sum())
                if n > cap:
                    raise ValueError("per-shard capacity too small")
                keys[k, :n] = ks[mine]
                vals[k, :n] = vs[mine]
                size[k] = n
        # host occupancy mirror: exact at init, upper bounds in between
        self._sizes_ub = size.astype(np.int64).copy()
        return MapState(*(                 # this rank's rows
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in self.placement.put((keys, vals, size), K)))

    @led
    def global_state(self) -> MapState:
        """The (K, capacity + 1) tables and (K,) sizes: the live state
        when stacked, an all-gather of every rank's rows under a mesh
        (every rank calls it)."""
        return self.placement.gather(self.state, self._comm)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    @led
    def __len__(self) -> int:
        return int(self._comm.sum(self.state.size.sum()))

    # -- occupancy guard ------------------------------------------------------
    def _refresh_sizes(self, sizes) -> None:
        self._sizes_ub = np.asarray(sizes, np.int64).copy()

    def occupancy_mirror(self):
        return {"sizes_ub": self._sizes_ub}

    def _guard_slices(self, slices) -> None:
        """Atomic sync-free overflow guard over ALL slices of a batch:
        refusal restores the mirror bit-for-bit and nothing is ever
        dispatched (the sharded-PQ overflow-audit contract)."""
        ub = self._sizes_ub.copy()
        for opk, code, nc in slices:
            ins = opk[:nc][code[:nc] == OP_INSERT]
            if ins.size:
                shards = _route_host(ins, self.n_shards, self.key_range)
                ub += np.bincount(shards, minlength=self.n_shards
                                  ).astype(np.int64)
            if np.any(ub > self.capacity):
                raise ValueError(
                    f"per-shard capacity {self.capacity} exceeded: "
                    f"insert routing would grow a shard past it")
        self._sizes_ub = ub

    # -- updates --------------------------------------------------------------
    @led
    def update_batch_async(self, methods: Sequence[str],
                           inputs: Sequence[Any]) -> AsyncMapUpdate:
        """Apply a combined MIXED update batch, arrival order preserved.

        ≤ c_max ops run as ONE pass; wider batches as back-to-back
        passes of c_max lanes.  NO blocking transfer: the per-op result
        masks stay on the device and ride the next read's fetch."""
        opk, opv, code = _encode_update_ops(methods, inputs)
        n_ops = len(methods)
        if n_ops == 0:
            handle = AsyncMapUpdate(self, [], [], self.c_max)
            handle._out = []
            return handle
        (ks, vs, cs), lane_counts = _pack_rows(
            (opk, opv, code), n_ops, self.c_max, (np.inf, 0.0, 0))
        slices = [(ks[r], cs[r], nc) for r, nc in enumerate(lane_counts)]

        def commit():
            # guard the WHOLE batch before dispatching anything — atomic;
            # inside the thunk so a transactional restore rewinds the
            # mirror and the device state together (DESIGN.md §15)
            self._guard_slices(slices)
            self.state, oks = apply_rounds(
                self.state, self._to_device(ks), self._to_device(vs),
                self._to_device(cs), lane_counts, key_range=self.key_range,
                donate=self.donate, merge=self._merge, comm=self._comm)
            return [oks]

        masks = self._guarded(commit, "map.apply_pass")
        handle = AsyncMapUpdate(self, masks, lane_counts, self.c_max)
        self._unresolved.append(handle)
        return handle

    def _resolve_through(self, handle: Optional[AsyncMapUpdate],
                         extra=None):
        """Fetch (once) the masks of EVERY unresolved update handle plus
        ``extra`` and the exact shard sizes, then resolve in dispatch
        order — one combined fetch is exactly the budgeted sync."""
        if handle is not None and handle not in self._unresolved:
            return None                        # already resolved
        if not self._unresolved and extra is None:
            return None
        return self._fetch_through(extra)

    @led(send_args=False)
    def _fetch_through(self, extra=None):
        """The one fetch of :meth:`_resolve_through`: every unresolved
        handle's masks, the gathered sizes and ``extra`` (a follower
        replays it bare, resolving its own handles and mirror alike)."""
        todo = list(self._unresolved)
        fetched = _host_fetch(([h.masks for h in todo],
                               self._comm.gather(self.state.size), extra))
        for h, masks_h in zip(todo, fetched[0]):
            h._resolve(masks_h)
            self._unresolved.remove(h)
        self._refresh_sizes(fetched[1])
        return fetched[2]

    # ``update_batch`` / generic ``apply`` inherit from BatchedStructure

    def insert(self, key: float, value: float) -> bool:
        return self.update_batch(["insert"], [(key, value)])[0]

    def assign(self, key: float, value: float) -> bool:
        return self.update_batch(["assign"], [(key, value)])[0]

    def delete(self, key: float) -> bool:
        return self.update_batch(["delete"], [key])[0]

    # -- reads ----------------------------------------------------------------
    @led
    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        """Answer a mixed read batch with ONE read pass and ONE blocking
        fetch (which also resolves every outstanding update handle and
        re-tightens the occupancy mirror)."""
        if not methods:
            return []
        qa, qb, kind = _encode_read_ops(methods, inputs)
        res, ok = _read_impl(self.state, self._to_device(qa),
                             self._to_device(qb), self._to_device(kind),
                             comm=self._comm)
        got = self._resolve_through(None, extra=(res, ok))
        return _convert_read_results(methods, got[0], got[1])

    def lookup(self, key: float) -> Optional[float]:
        return self.read_batch(["lookup"], [key])[0]

    def range_count(self, lo: float, hi: float) -> int:
        return self.read_batch(["range_count"], [(lo, hi)])[0]

    def range_sum(self, lo: float, hi: float) -> float:
        return self.read_batch(["range_sum"], [(lo, hi)])[0]

    def kth_smallest(self, k: int) -> Optional[float]:
        return self.read_batch(["kth_smallest"], [k])[0]

    # -- mixed update+read megapass (DESIGN.md §17) ---------------------------
    @led
    def mixed_rounds(self, rounds):
        """R heterogeneous update/read rounds as one dispatch: every
        round's rows run back to back with no host sync between them, and
        every returned handle resolves through ONE shared fetch.  Round
        r+1 observes all of round r's effects.  Refusal is atomic across
        the whole megapass: the occupancy guard validates every update
        slice before anything runs."""
        c = self.c_max
        a_rows, b_rows, code_rows = [], [], []
        tags: List[int] = []
        nbs: List[int] = []
        plans: List[Tuple] = []
        upd_slices = []
        for kind, methods, inputs in rounds:
            methods, inputs = list(methods), list(inputs)
            n = len(methods)
            row_lo = len(tags)
            if kind == "update":
                opk, opv, code = _encode_update_ops(methods, inputs)
                (ka, va, ca), counts = _pack_rows(
                    (opk, opv, code), n, c, (np.inf, 0.0, 0))
                tag = MEGA_UPDATE
                upd_slices += [(ka[r], ca[r], nc)
                               for r, nc in enumerate(counts)]
                plans.append(("update", row_lo, counts))
            elif kind == "read":
                qa, qb, qk = _encode_read_ops(methods, inputs)
                (ka, va, ca), counts = _pack_rows(
                    (qa, qb, qk), n, c, (0.0, -1.0, RD_COUNT))
                tag = MEGA_READ
                plans.append(("read", row_lo, counts, methods))
            else:
                raise ValueError(f"unknown round kind {kind!r} "
                                 f"(want 'update' or 'read')")
            a_rows += list(ka)
            b_rows += list(va)
            code_rows += list(ca)
            tags += [tag] * len(counts)
            nbs += counts
        if not tags:
            return [substrate._DoneReads([]) for _ in plans]
        ra, rb, rc = (np.stack(x) for x in (a_rows, b_rows, code_rows))

        def commit():
            self._guard_slices(upd_slices)
            self.state, res_rows, ok_rows = mixed_rounds_pass(
                self.state, tags, self._to_device(ra), self._to_device(rb),
                self._to_device(rc), nbs, key_range=self.key_range,
                donate=self.donate, merge=self._merge, comm=self._comm)
            return res_rows, ok_rows

        res_rows, ok_rows = self._guarded(commit, "map.mixed_rounds")
        shared = _MegapassFetch(self, res_rows, ok_rows)
        handles: List[Any] = []
        for plan in plans:
            if plan[0] == "update":
                _, row_lo, counts = plan
                inner = AsyncMapUpdate(self, [], counts, c)
                if not counts:
                    inner._out = []
                else:
                    shared._upd.append((inner, row_lo, row_lo + len(counts)))
                handles.append(_MegaUpdateRound(shared, inner))
            else:
                _, row_lo, counts, methods = plan
                if not counts:
                    handles.append(substrate._DoneReads([]))
                else:
                    handles.append(_MegaReadRound(shared, row_lo, counts,
                                                  methods))
        return handles

    # -- debug / test helpers -------------------------------------------------
    def items(self) -> List[Tuple[float, float]]:
        """Host copy of the live (key, value) pairs, ascending (one
        fetch; test/debug)."""
        keys, vals, size = _host_fetch(tuple(self.global_state()))
        out: List[Tuple[float, float]] = []
        for k in range(self.n_shards):
            n = int(size[k])
            out.extend(zip(keys[k, :n].tolist(), vals[k, :n].tolist()))
        return sorted(out)


class BatchedMap(ShardedMap):
    """Single-shard convenience wrapper (the §13 core structure)."""

    def __init__(self, capacity: int, c_max: int, items=None,
                 use_pallas: bool = False, donate: bool = True,
                 fault_plan=None, guard=None, placement=None, device=None):
        super().__init__(capacity, c_max=c_max, n_shards=1, items=items,
                         use_pallas=use_pallas, donate=donate,
                         fault_plan=fault_plan, guard=guard,
                         placement=placement, device=device)


# ---------------------------------------------------------------------------
# Registration (DESIGN.md §16) — factories + op generators + adaptive hooks
# ---------------------------------------------------------------------------
from . import read_opt as _read_opt  # noqa: E402
from .seq_map import SequentialSortedMap  # noqa: E402

_KEY_RANGE = (0.0, 100.0)


def _gen_update(rng, k, ctx):
    """Pool-biased mixed batches: 60% revisit a known key (so deletes and
    assigns actually hit), insert/assign/delete at 50/25/25."""
    pool = ctx.setdefault("keys", [])
    methods, inputs = [], []
    for _ in range(k):
        if pool and rng.random() < 0.6:
            key = pool[int(rng.integers(len(pool)))]
        else:
            key = _qkey(float(rng.uniform(_KEY_RANGE[0], _KEY_RANGE[1])))
            pool.append(key)
        r = rng.random()
        if r < 0.5:
            methods.append("insert")
            inputs.append((key, _qval(float(rng.uniform(-50.0, 50.0)))))
        elif r < 0.75:
            methods.append("assign")
            inputs.append((key, _qval(float(rng.uniform(-50.0, 50.0)))))
        else:
            methods.append("delete")
            inputs.append(key)
    return methods, inputs


def _gen_read(rng, k, ctx):
    pool = ctx.setdefault("keys", [])
    methods, inputs = [], []
    for _ in range(k):
        r = rng.random()
        if r < 0.35 and pool:
            methods.append("lookup")
            inputs.append(pool[int(rng.integers(len(pool)))])
        elif r < 0.5:
            methods.append("lookup")
            inputs.append(_qkey(float(rng.uniform(_KEY_RANGE[0],
                                                  _KEY_RANGE[1]))))
        elif r < 0.7:
            lo, hi = sorted((float(rng.uniform(*_KEY_RANGE)),
                             float(rng.uniform(*_KEY_RANGE))))
            methods.append("range_count")
            inputs.append((_qkey(lo), _qkey(hi)))
        elif r < 0.85:
            lo, hi = sorted((float(rng.uniform(*_KEY_RANGE)),
                             float(rng.uniform(*_KEY_RANGE))))
            methods.append("range_sum")
            inputs.append((_qkey(lo), _qkey(hi)))
        else:
            methods.append("kth_smallest")
            inputs.append(int(rng.integers(1, 21)))
    return methods, inputs


def _result_ok(method: str, got: Any, want: Any) -> bool:
    """The reference's tolerance: ``range_sum`` is a float sum whose bits
    depend on the summation order, every other answer is exact up to the
    f32 image."""
    if method == "range_sum":
        return abs(got - want) <= 1e-3 + 1e-5 * abs(want)
    if method in ("lookup", "kth_smallest"):
        if got is None or want is None:
            return got is None and want is None
        return abs(got - want) <= 1e-6 * max(1.0, abs(want))
    return got == want


def _refusal_batch(ds: ShardedMap):
    """capacity + 1 distinct keys packed into the lowest quarter of shard
    0's key range: every one routes to shard 0, so the batch must be
    refused whatever the other shards hold."""
    lo, hi = ds.key_range if ds.key_range else _KEY_RANGE
    sliver = lo + (hi - lo) / (4.0 * ds.n_shards)
    n = ds.capacity + 1
    ks = [_qkey(float(x)) for x in
          np.linspace(lo, sliver, num=4 * n).tolist()]
    ks = sorted(set(ks))[:n]
    assert len(ks) == n
    return (["insert"] * n, [(k, 1.0) for k in ks])


def _make(capacity: int = 256, c_max: int = 8, n_shards: int = 4,
          **kw) -> ShardedMap:
    kw.setdefault("key_range", _KEY_RANGE)
    return ShardedMap(capacity, c_max=c_max, n_shards=n_shards, **kw)


def _dump_compare(ds: ShardedMap, oracle) -> None:
    got, want = ds.items(), oracle.items()
    assert len(got) == len(want), (got, want)
    if got:
        gk, gv = zip(*got)
        wk, wv = zip(*want)
        assert np.allclose(gk, wk) and np.allclose(gv, wv), (got, want)


substrate.register(substrate.StructureSpec(
    name="map",
    module="repro_torch.core.batched_map",
    title="batched ordered map",
    make=_make,
    make_host=lambda ds: SequentialSortedMap(ds.items()),
    gen_update=_gen_update,
    gen_read=_gen_read,
    result_ok=_result_ok,
    dump_compare=_dump_compare,
    canon=_read_opt._canon_map_op,
    compact=_read_opt._compact_map,
    refusal_batch=_refusal_batch,
    megapass=True,
    extras={"serve_kw": dict(capacity=512, c_max=64, n_shards=4),
            # the constructor takes placement= (DESIGN.md §18); serve.py
            # keys --mesh-shards off this marker
            "placement": True},
))
