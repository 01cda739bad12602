"""Device-resident batched counting/top-k sketch (DESIGN.md §16).

The port of ``repro.core.batched_sketch``.  A bounded table of ``key ->
count`` counters, hash-sharded (``sharded_pq.route_hash``) across K
sorted-array shards with the map's scratch-slot layout.  Updates are
``add(key, w)`` with positive integer weights stored as f32 — integer-
valued sums are exact in f32 while they stay below 2^24, so the per-slice
class totals match a sequential oracle bit for bit.  ``add`` returns True
iff the op CREATED the counter (arrival order: later duplicate lanes in
the slice see it present).  Reads — ``count`` / ``total`` / ``distinct``
/ ``topk`` — answer in one read pass and one blocking fetch; ``topk``
merges per-shard top-M candidate lists on the host (count descending,
key ascending tie-break; exact because a global top-k element is in its
shard's top-k for any k ≤ M).

One apply pass bumps the existing counters in place (a predicated
scatter-add) and rebuilds every shard with ONE merge-compact
(``kernels/sorted_merge``: the hand-written kernel on the card, its plain
version on the CPU) that merges the sorted run of new counters in; like
the map's, it writes a fresh row block and drops the old one
(``donate=False`` clones the state first).  The substrate idioms carry
over: rounds as back-to-back passes (DESIGN.md §12), the sync-free
occupancy guard with an atomic host mirror (DESIGN.md §10),
transactional snapshot/restore (DESIGN.md §15) and the one-fetch
contract (DESIGN.md §11).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Set, \
    Tuple

import numpy as np
import torch

from ..kernels.sorted_merge import merge_compact_sharded
from . import substrate
from .batched_map import (AsyncMapUpdate, _fresh_rows, _lane_results,
                          _pack_rows, _route_rows, _search, clone_state)
from .batched_pq import INF, _device_get, _flush_subnormals, resolve_device
from .faults import make_guard
from .seq_sketch import SequentialSketch, _qk, _qw, quantize_items
from .sharded_pq import route_hash_host

# test hook: module-level so sync-counting tests can monkeypatch it
_host_fetch = _device_get

RD_COUNT = 0
RD_TOTAL = 1
RD_DISTINCT = 2
RD_TOPK = 3
_READ_CODE = {"count": RD_COUNT, "total": RD_TOTAL,
              "distinct": RD_DISTINCT, "topk": RD_TOPK}


class SketchState(NamedTuple):
    """K sorted-array shards; index ``capacity`` is the scratch slot
    (predicated-scatter target for inactive lanes, the map idiom)."""

    keys: torch.Tensor    # (K, capacity+1) f32 ascending in [0,size), +inf pad
    counts: torch.Tensor  # (K, capacity+1) f32 integer-valued, +inf past size
    size: torch.Tensor    # (K,) int32


# ---------------------------------------------------------------------------
# Add pass — class-total sort-merge
# ---------------------------------------------------------------------------
def _prep(keys, counts, size, k1, w1, nb1):
    """Net every shard's ≤ c add row down to merge-compact inputs (the
    reference's ``_prep_one``, over the shard axis).

    Bumps existing counters in ``counts`` IN PLACE and returns ``(keep,
    b_keys, b_counts, b_count, new_size, ok)``.  Increments commute, so
    the chain rule collapses: one representative lane per key class
    carries the class's WEIGHT TOTAL, and only the first lane of an
    absent key reports created=True."""
    K, c = k1.shape
    cap = keys.shape[1] - 1
    dev = keys.device
    lane = torch.arange(c, device=dev)
    active = lane[None, :] < nb1[:, None]

    pos, _, in_tab = _search(keys, k1, size)
    same = ((k1[:, :, None] == k1[:, None, :])
            & active[:, :, None] & active[:, None, :])    # (K, c, c)
    is_rep = active & ~(same & (lane[None, :] < lane[:, None])).any(2)
    wsum = torch.where(same, w1[:, None, :], 0.0).sum(2)
    ok = is_rep & ~in_tab                                 # created

    # existing counters bump in place (predicated scatter-add)
    upd = is_rep & in_tab
    counts.scatter_add_(1, torch.where(upd, pos, cap),
                        torch.where(upd, wsum, 0.0))

    # no deletions: every live slot survives the merge
    keep = torch.arange(cap, device=dev)[None, :] < size[:, None]

    # new counters become the sorted b-run (distinct keys by rep-ness)
    add = is_rep & ~in_tab
    bkey_raw = torch.where(add, k1, INF)
    order = torch.argsort(bkey_raw, dim=1, stable=True)
    b_keys = bkey_raw.gather(1, order)
    b_counts = torch.where(add, wsum, INF).gather(1, order)
    b_count = add.sum(1, dtype=torch.int32)
    return keep, b_keys, b_counts, b_count, size + b_count, ok


def _apply_impl(state: SketchState, op_keys: torch.Tensor,
                op_w: torch.Tensor, nb: int, *,
                merge: Callable = merge_compact_sharded
                ) -> Tuple[SketchState, torch.Tensor]:
    """Apply ≤ c adds as ONE pass.  ``op_keys``/``op_w``: (c,) f32;
    ``nb``: live lane count (host int).  Returns ``(state, ok)`` with the
    per-lane created flags left on the device.  ``merge`` is the
    yardstick seam (see ``batched_map._apply_impl``)."""
    keys, counts, size = state
    K = keys.shape[0]
    cap = keys.shape[1] - 1
    k = _flush_subnormals(op_keys.to(torch.float32))
    w = op_w.to(torch.float32)
    (rows_k, rows_w), cnts, shard_of, rank = _route_rows(
        k, [(k, INF), (w, 0.0)], nb, K, None)
    keep, b_keys, b_counts, b_count, new_size, ok_rows = _prep(
        keys, counts, size, rows_k, rows_w, cnts)
    new_keys, new_counts = _fresh_rows(keys), _fresh_rows(counts)
    merge(keys[:, :cap], counts[:, :cap], keep, b_keys, b_counts, b_count,
          out=(new_keys[:, :cap], new_counts[:, :cap]))
    return (SketchState(new_keys, new_counts, new_size),
            _lane_results(ok_rows, shard_of, rank, nb))


def apply_rounds(state: SketchState, op_keys, op_w, nb: Sequence[int], *,
                 donate: bool = True,
                 merge: Callable = merge_compact_sharded):
    """R sequential ≤ c slices back to back on one stream (DESIGN.md
    §12): ``op_keys``/``op_w`` (R, c), ``nb`` R host ints.  Returns
    ``(state, oks (R, c))``; ``donate=False`` leaves ``state`` untouched."""
    if not donate:
        state = clone_state(state)
    oks = []
    for r, n in enumerate(nb):
        state, ok = _apply_impl(state, op_keys[r], op_w[r], n, merge=merge)
        oks.append(ok)
    return state, torch.stack(oks)


# ---------------------------------------------------------------------------
# Vectorized read pass (reads copy nothing)
# ---------------------------------------------------------------------------
def _read_impl(state: SketchState, qa: torch.Tensor, qkind: torch.Tensor, *,
               topk_m: int = 8):
    """Answer a mixed read batch in one pass, on the device.

    ``qa``: (q,) f32 — the key (count; unused otherwise); ``qkind``:
    (q,) int32.  Returns ``(res (q,) f32, tk (K, M) f32, tc (K, M)
    f32)`` — the per-shard top-M candidate lists every ``topk`` query in
    the batch merges on the host (exact for k ≤ M)."""
    keys, counts, size = state
    K = keys.shape[0]
    cap = keys.shape[1] - 1
    dev = keys.device
    qa = _flush_subnormals(qa.to(torch.float32))
    qa_k = qa[None, :].expand(K, qa.shape[0]).contiguous()
    _, pos_c, found = _search(keys, qa_k, size)
    cval = torch.where(found, counts.gather(1, pos_c), 0.0)
    live = torch.arange(cap, device=dev)[None, :] < size[:, None]
    tot = torch.where(live, counts[:, :cap], 0.0).sum(1)
    # per-shard top-M by (count desc, key asc): the body is sorted by key,
    # so ONE stable sort on -count gives the reference's two-key order;
    # dead slots sink via a +inf negated count
    negc = torch.where(live, -counts[:, :cap], INF)
    negc_s, order = torch.sort(negc, dim=1, stable=True)
    tk = keys[:, :cap].gather(1, order[:, :topk_m])
    top = negc_s[:, :topk_m]
    tc = torch.where(top < INF, -top, 0.0)

    cnt = cval.sum(0)                      # one shard holds the key
    total = tot.sum()
    distinct = size.sum().to(torch.float32)
    res = torch.where(
        qkind == RD_COUNT, cnt,
        torch.where(qkind == RD_TOTAL, total,
                    torch.where(qkind == RD_DISTINCT, distinct, 0.0)))
    return res, tk, tc


# Deferred per-op created flags (one-fetch contract, DESIGN.md §11): the
# map's handle, whose owner resolves it through its next read fetch.
AsyncSketchUpdate = AsyncMapUpdate


# ---------------------------------------------------------------------------
# Host-facing wrapper
# ---------------------------------------------------------------------------
class ShardedSketch(substrate.BatchedStructure):
    """K-sharded device-resident counting/top-k sketch.

    Args:
      capacity: per-shard counter capacity (plus one scratch slot).
      c_max: combined update-batch capacity per pass.
      n_shards: shard count K (hash routing — no key_range needed).
      topk_max: per-shard candidate width M; ``topk(k)`` requires k ≤ M
        (exactness bound for the host-side merge).
      items: optional initial (key, weight) pairs.
      use_pallas: kept for API parity; the device picks the merge path.
      donate / fault_plan / guard: the uniform knob set (DESIGN.md
        §10/§13/§15).
      device: ``None`` means the card (``"cuda"``) and raises without
        one; the tests pass ``"cpu"``.
    """

    structure = "sketch"
    read_only: Set[str] = {"count", "total", "distinct", "topk"}
    # No fused megapass lowering: mixed_rounds rides the base fallback
    # (one pass per round), as in the reference.
    supports_megapass = False

    def __init__(self, capacity: int, c_max: int, n_shards: int = 1,
                 topk_max: int = 8, items=None, use_pallas: bool = False,
                 donate: bool = True, fault_plan=None, guard=None,
                 device=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if c_max < 1:
            raise ValueError("c_max must be >= 1")
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if topk_max < 1:
            raise ValueError("topk_max must be >= 1")
        self.capacity = int(capacity)
        self.c_max = int(c_max)
        self.n_shards = int(n_shards)
        self.topk_max = int(topk_max)
        self.use_pallas = bool(use_pallas)
        self.donate = bool(donate)
        self.device = resolve_device(device)
        self.fault_plan = fault_plan
        self._guard = make_guard(fault_plan, guard)
        self.state = self._init_state(items)
        self._unresolved: List[AsyncSketchUpdate] = []
        # the yardstick seam (see ShardedMap._merge)
        self._merge: Callable = merge_compact_sharded

    # -- transactional dispatch (DESIGN.md §15) -------------------------------
    def _snapshot(self):
        return clone_state(self.state), self._sizes_ub.copy()

    def _restore(self, snap) -> None:
        self.state, self._sizes_ub = snap

    def _init_state(self, items) -> SketchState:
        K, cap = self.n_shards, self.capacity
        keys = np.full((K, cap + 1), np.inf, np.float32)
        counts = np.full((K, cap + 1), np.inf, np.float32)
        size = np.zeros((K,), np.int32)
        if items:
            ks, cs = quantize_items(items)
            cs = cs.astype(np.float32)
            shards = route_hash_host(ks, K)
            for k in range(K):
                mine = shards == k
                n = int(mine.sum())
                if n > cap:
                    raise ValueError("per-shard capacity too small")
                keys[k, :n] = ks[mine]
                counts[k, :n] = cs[mine]
                size[k] = n
        self._sizes_ub = size.astype(np.int64).copy()
        return SketchState(*(torch.from_numpy(a).to(self.device)
                             for a in (keys, counts, size)))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def __len__(self) -> int:
        return int(self.state.size.sum())

    # -- occupancy guard (DESIGN.md §10) --------------------------------------
    def _refresh_sizes(self, sizes) -> None:
        self._sizes_ub = np.asarray(sizes, np.int64).copy()

    def occupancy_mirror(self):
        return {"sizes_ub": self._sizes_ub}

    def _guard_slices(self, slices) -> None:
        """Atomic sync-free overflow guard over ALL slices: every add is
        a potential new counter (upper bound — duplicates re-tighten at
        the next fetch); refusal restores the mirror bit-for-bit and
        nothing is ever dispatched."""
        ub = self._sizes_ub.copy()
        for opk, nc in slices:
            if nc:
                shards = route_hash_host(opk[:nc], self.n_shards)
                ub += np.bincount(shards, minlength=self.n_shards
                                  ).astype(np.int64)
            if np.any(ub > self.capacity):
                raise ValueError(
                    f"per-shard capacity {self.capacity} exceeded: "
                    f"add routing would grow a shard past it")
        self._sizes_ub = ub

    # -- updates --------------------------------------------------------------
    def update_batch_async(self, methods: Sequence[str],
                           inputs: Sequence[Any]) -> AsyncSketchUpdate:
        """Apply a combined add batch: ≤ c_max ops run as ONE pass, wider
        batches as back-to-back passes.  NO blocking transfer (DESIGN.md
        §11/§12)."""
        n_ops = len(methods)
        opk = np.zeros((n_ops,), np.float32)
        opw = np.zeros((n_ops,), np.float32)
        for i, (m, inp) in enumerate(zip(methods, inputs)):
            if m != "add":
                raise ValueError(f"unknown update method {m!r}")
            opk[i] = _qk(inp[0])
            opw[i] = _qw(inp[1])
        if n_ops == 0:
            handle = AsyncSketchUpdate(self, [], [], self.c_max)
            handle._out = []
            return handle
        (ks, ws), lane_counts = _pack_rows((opk, opw), n_ops, self.c_max,
                                           (np.inf, 0.0))
        slices = [(ks[r], nc) for r, nc in enumerate(lane_counts)]

        def commit():
            # guard the WHOLE batch before dispatching anything; inside
            # the thunk so a transactional restore rewinds mirror + state
            # together (DESIGN.md §15)
            self._guard_slices(slices)
            self.state, oks = apply_rounds(
                self.state, self._to_device(ks), self._to_device(ws),
                lane_counts, donate=self.donate, merge=self._merge)
            return [oks]

        if self._guard is None:
            masks = commit()
        else:
            masks = self._guard.run(commit, self._snapshot, self._restore,
                                    site="sketch.apply_pass")
        handle = AsyncSketchUpdate(self, masks, lane_counts, self.c_max)
        self._unresolved.append(handle)
        return handle

    def _resolve_through(self, handle: Optional[AsyncSketchUpdate],
                         extra=None):
        """ONE combined fetch resolves every unresolved handle plus
        ``extra`` and re-tightens the mirror (DESIGN.md §11)."""
        todo = list(self._unresolved)
        if handle is not None and handle not in todo:
            todo = []
        if not todo and extra is None:
            return None
        fetched = _host_fetch(([h.masks for h in todo], self.state.size,
                               extra))
        for h, masks_h in zip(todo, fetched[0]):
            h._resolve(masks_h)
            self._unresolved.remove(h)
        self._refresh_sizes(fetched[1])
        return fetched[2]

    def add(self, key: float, w: float = 1.0) -> bool:
        return self.update_batch(["add"], [(key, w)])[0]

    # -- reads ----------------------------------------------------------------
    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        """ONE read pass + ONE blocking fetch for the whole batch
        (resolves outstanding update handles, re-tightens the mirror)."""
        nq = len(methods)
        if nq == 0:
            return []
        qa = np.zeros((nq,), np.float32)
        kind = np.full((nq,), RD_TOTAL, np.int32)
        for i, (m, inp) in enumerate(zip(methods, inputs)):
            if m not in _READ_CODE:
                raise ValueError(f"unknown read method {m!r}")
            kind[i] = _READ_CODE[m]
            if m == "count":
                qa[i] = _qk(inp)
            elif m == "topk":
                kq = int(inp)
                if not 1 <= kq <= self.topk_max:
                    raise ValueError(
                        f"topk k={kq} outside [1, topk_max="
                        f"{self.topk_max}]")
        res, tk, tc = _read_impl(self.state, self._to_device(qa),
                                 self._to_device(kind),
                                 topk_m=self.topk_max)
        res_h, tk_h, tc_h = self._resolve_through(None, extra=(res, tk, tc))
        if "topk" in methods:
            # merge the K per-shard candidate lists: count desc, key asc
            cand = sorted(
                ((float(k), float(c))
                 for k, c in zip(tk_h.ravel(), tc_h.ravel()) if c > 0),
                key=lambda kc: (-kc[1], kc[0]))
        out: List[Any] = []
        for i, m in enumerate(methods):
            if m == "topk":
                out.append(cand[: int(inputs[i])])
            elif m == "distinct":
                out.append(int(res_h[i]))
            else:                       # count / total
                out.append(float(res_h[i]))
        return out

    def count(self, key: float) -> float:
        return self.read_batch(["count"], [key])[0]

    def total(self) -> float:
        return self.read_batch(["total"], [None])[0]

    def distinct(self) -> int:
        return self.read_batch(["distinct"], [None])[0]

    def topk(self, k: int) -> List[Tuple[float, float]]:
        return self.read_batch(["topk"], [k])[0]

    # -- debug / test helpers -------------------------------------------------
    def counters(self) -> List[Tuple[float, float]]:
        """Host copy of live (key, count) pairs, ascending (one fetch)."""
        keys, counts, size = _host_fetch((self.state.keys,
                                          self.state.counts,
                                          self.state.size))
        out: List[Tuple[float, float]] = []
        for k in range(self.n_shards):
            n = int(size[k])
            out.extend(zip(keys[k, :n].tolist(), counts[k, :n].tolist()))
        return sorted(out)


# ---------------------------------------------------------------------------
# Registration (DESIGN.md §16) — factories + op generators + adaptive hooks
# ---------------------------------------------------------------------------
def _gen_update(rng, k, ctx):
    """Pool-biased add batches: 60% revisit a hot key, else a fresh one."""
    pool = ctx.setdefault("keys", [])
    methods, inputs = [], []
    for _ in range(k):
        if pool and rng.random() < 0.6:
            key = pool[int(rng.integers(len(pool)))]
        else:
            key = _qk(float(rng.uniform(0.0, 100.0)))
            pool.append(key)
        methods.append("add")
        inputs.append((key, float(int(rng.integers(1, 10)))))
    return methods, inputs


def _gen_read(rng, k, ctx):
    pool = ctx.setdefault("keys", [])
    methods, inputs = [], []
    for _ in range(k):
        r = rng.random()
        if r < 0.4 and pool:
            methods.append("count")
            inputs.append(pool[int(rng.integers(len(pool)))])
        elif r < 0.55:
            methods.append("count")
            inputs.append(_qk(float(rng.uniform(0.0, 100.0))))
        elif r < 0.7:
            methods.append("total")
            inputs.append(None)
        elif r < 0.85:
            methods.append("distinct")
            inputs.append(None)
        else:
            methods.append("topk")
            inputs.append(int(rng.integers(1, 6)))
    return methods, inputs


def _canon_op(method: str, input: Any) -> Any:
    """Adaptive-tier op canonicalization (DESIGN.md §14): quantize keys
    and weights to the exact images both tiers store."""
    if method == "add":
        return (_qk(input[0]), _qw(input[1]))
    if method == "count":
        return _qk(input)
    return input


def _compact(log, host):
    """Increments commute: one add per key with the summed weight."""
    totals, order = {}, []
    for _m, (key, w) in log:
        if key not in totals:
            order.append(key)
        totals[key] = totals.get(key, 0.0) + w
    return [("add", (key, totals[key])) for key in order]


def _refusal_batch(ds: ShardedSketch):
    """More distinct fresh keys than total capacity: pigeonhole forces a
    per-shard overflow whatever the hash routing does."""
    n = ds.capacity * ds.n_shards + 1
    return (["add"] * n,
            [(1.0e6 + 2.0 * i, 1.0) for i in range(n)])


def _make(capacity: int = 512, c_max: int = 8, n_shards: int = 2,
          **kw) -> ShardedSketch:
    return ShardedSketch(capacity, c_max=c_max, n_shards=n_shards, **kw)


def _dump_compare(ds: ShardedSketch, oracle: SequentialSketch) -> None:
    got, want = ds.counters(), oracle.items()
    assert len(got) == len(want), (got, want)
    for (gk, gc), (wk, wc) in zip(got, want):
        assert gk == wk and gc == wc, (got, want)


substrate.register(substrate.StructureSpec(
    name="sketch",
    module="repro_torch.core.batched_sketch",
    title="counting/top-k sketch",
    make=_make,
    make_host=lambda ds: SequentialSketch(ds.counters()),
    gen_update=_gen_update,
    gen_read=_gen_read,
    dump_compare=_dump_compare,
    canon=_canon_op,
    compact=_compact,
    refusal_batch=_refusal_batch,
    extras={"serve_kw": dict(capacity=1024, c_max=32, n_shards=4)},
))
