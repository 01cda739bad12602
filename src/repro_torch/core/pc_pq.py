"""Parallel-combining priority queue (§4 wired into the §3.1 engine).

The port of ``repro.core.pc_pq``; the host engine is unchanged and the
combined batch runs on the port's device heaps.

The combiner drains the publication list, splits requests into E (extract)
and I (insert) exactly as §4, and applies the combined batch as ONE device
program (`BatchedPriorityQueue.apply`) — phases 1-4 of the paper run inside
it, with device lanes playing the clients.  CLIENT_CODE is empty on the
host: the lanes already did the sift/insert work.

Elimination pre-pass (DESIGN.md §12): before dispatching, the combiner
matches Insert/ExtractMin pairs whose insert value provably undercuts the
queue's current minimum (`eliminate_pq_pairs`) and answers them host-side —
matched pairs never touch the device.  The bound it needs (`min_lb ≤ true
queue min`) is tracked for free from the combiner's own op stream: the
combiner is the queue's only writer, extraction answers are ascending, and
conservation gives the live count (an empty queue makes EVERY pair
eliminable — the high-hit-rate regime).

The paper's `|A| > size/4 → classic combining` rule was a performance
heuristic for the 64-thread host; our batched implementation is correct for
any batch/size ratio (fuzzed including batch > size), so the fallback is
kept only as an optional policy knob.
"""
from __future__ import annotations

import contextlib
import math
from collections import Counter
from typing import List, Optional, Union

import numpy as np

from .batched_pq import BatchedPriorityQueue
from .combining import (ALL_TIERS, TIER_DEVICE, TIER_ELIMINATE, TIER_HOST,
                        CostModel,
                        ParallelCombiner, Request, Status, TierRouter,
                        eliminate_pq_pairs, track_pq_batch)
from .seq_pq import SequentialHeap
from .sharded_pq import ShardedBatchedPQ, host_key

AnyBatchedPQ = Union[BatchedPriorityQueue, ShardedBatchedPQ]


def _quantize_key(x: float) -> float:
    """The exact f32 key the device heap will store, keeping the PQ
    engines' finite-keys contract (±inf raises here where the
    scheduler's deadline path clamps — the quantization core itself is
    ``host_key``, one source of the f32 + flush-to-zero rule).

    Load-bearing for elimination: the min tracking must see the STORED
    key — a raw f64 fed to the bound could sit above its f32 image and
    let an insert eliminate against a stale-high minimum."""
    k = float(np.float32(x))
    if math.isnan(k) or math.isinf(k):
        raise ValueError(
            "keys must be finite f32: ±inf is the heap's empty-slot "
            "sentinel and NaN breaks the frontier search")
    return host_key(k)


def pc_priority_queue(pq: AnyBatchedPQ, *,
                      sequential_fallback: bool = False,
                      eliminate: bool = True,
                      **kw) -> ParallelCombiner:
    # host min-tracking state for the elimination pre-pass: n_live by
    # conservation, min_lb from the ascending extraction answers.  One
    # device sync here, at engine construction, never on the hot path.
    n_live = len(pq)
    track = {"n_live": n_live,
             "min_lb": math.inf if n_live == 0 else -math.inf}

    def combiner_code(engine: ParallelCombiner, requests: List[Request]) -> None:
        extracts = [r for r in requests if r.method == "extract_min"]
        inserts = [r for r in requests if r.method == "insert"]
        if sequential_fallback and len(requests) * 4 > max(1, len(pq)):
            # classic (flat) combining path, one op at a time
            for r in requests:
                if r.method == "insert":
                    pq.apply(0, [r.input])
                    track["n_live"] += 1
                else:
                    out = pq.apply(1, [])
                    r.res = out[0]
                    track["n_live"] -= out[0] is not None
                r.status = Status.FINISHED
            track["min_lb"] = (math.inf if track["n_live"] == 0
                               else -math.inf)
            return
        # elimination pre-pass (DESIGN.md §12): matched pairs are served
        # host-side; the device only sees the survivors.  Keys quantize
        # to their stored f32 image first (see _quantize_key).
        ins_vals = [_quantize_key(r.input) for r in inserts]
        if eliminate:
            served, rest_ins, rest_ne = eliminate_pq_pairs(
                len(extracts), ins_vals, track["min_lb"])
        else:
            served, rest_ins, rest_ne = [], sorted(ins_vals), len(extracts)
        engine.eliminated += len(served)
        for r, v in zip(extracts, served):
            r.res = v
            r.status = Status.FINISHED
        if rest_ne or rest_ins:
            res = pq.apply(rest_ne, rest_ins)
            track_pq_batch(track, res, rest_ne, rest_ins)
        else:
            res = []    # fully eliminated: zero device work, not even a sync
        for r, v in zip(extracts[len(served):], res):
            r.res = v
            r.status = Status.FINISHED
        for r in inserts:
            r.res = None
            r.status = Status.FINISHED

    def client_code(engine: ParallelCombiner, r: Request) -> None:
        return

    engine = ParallelCombiner(combiner_code, client_code, **kw)
    engine.eliminated = 0        # elimination hit counter (instrumentation)
    engine.pq = pq               # the device queue, for state checks
    return engine


class AsyncRoundsPQ:
    """Async parallel-combining PQ with fused multi-round dispatch
    (DESIGN.md §12) — the command-queue counterpart of the spin-engine
    :func:`pc_priority_queue`.

    Clients publish ops non-blockingly: :meth:`insert` is fire-and-forget,
    :meth:`extract_async` returns a ``concurrent.futures`` future.  A
    dedicated combiner thread drains the publication buffer, runs the
    elimination pre-pass (matched Insert/ExtractMin pairs are answered
    host-side), packs the survivors into up to ``rounds_cap`` sequential
    rounds of ≤ c_max ops each — R adaptive from the backlog — and applies
    them with ONE ``apply_rounds`` dispatch + one blocking fetch,
    resolving the extract futures round by round.  Linearization: ops in
    one round are concurrent (their combining pass), rounds are sequential.

    Instrumentation: ``dispatches`` (fused device programs), ``rounds``
    (combining rounds executed), ``eliminated`` (pairs served host-side).
    """

    def __init__(self, pq: AnyBatchedPQ, *, rounds_cap: int = 4,
                 eliminate: bool = True):
        import threading
        from collections import deque

        self.pq = pq
        self.rounds_cap = max(1, int(rounds_cap))
        self.eliminate = bool(eliminate)
        n_live = len(pq)
        self._track = {"n_live": n_live,
                       "min_lb": math.inf if n_live == 0 else -math.inf}
        self._ops = deque()            # (is_insert, value_or_future)
        self._cond = threading.Condition()
        self._closed = False
        self.dispatches = 0
        self.rounds = 0
        self.eliminated = 0
        self.last_window_pairs: list = []
        self._thread = threading.Thread(target=self._loop,
                                        name="pc-rounds", daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------
    def insert(self, value: float) -> None:
        """Publish an Insert (non-blocking, nothing to wait for).  The
        key quantizes to its stored f32 image at this boundary so the
        elimination bound only ever sees device-exact keys."""
        value = _quantize_key(value)
        with self._cond:
            if self._closed:
                raise RuntimeError("combiner is closed")
            self._ops.append((True, value))
            self._cond.notify()

    def extract_async(self):
        """Publish an ExtractMin; returns a future for its answer."""
        from concurrent.futures import Future

        f: "Future" = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("combiner is closed")
            self._ops.append((False, f))
            self._cond.notify()
        return f

    def close(self) -> None:
        """Drain every published op, then stop the combiner thread."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join()

    def __enter__(self) -> "AsyncRoundsPQ":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- combiner side ------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and not self._ops:
                    self._cond.wait()
                if self._closed and not self._ops:
                    return
                ops = self._ops
                budget = self.rounds_cap
                window = []
                ne = ni = 0
                rounds_ops = []
                while ops and len(rounds_ops) < budget:
                    is_ins, payload = ops[0]
                    if (ni + is_ins > self.pq.c_max
                            or ne + (not is_ins) > self.pq.c_max):
                        rounds_ops.append(window)
                        window, ne, ni = [], 0, 0
                        continue
                    ops.popleft()
                    window.append((is_ins, payload))
                    ni += is_ins
                    ne += not is_ins
                if window and len(rounds_ops) < budget:
                    rounds_ops.append(window)
            try:
                self._apply_rounds(rounds_ops)
            except BaseException as exc:
                for w in rounds_ops:
                    for is_ins, payload in w:
                        if not is_ins and not payload.done():
                            payload.set_exception(exc)

    def _apply_rounds(self, rounds_ops) -> None:
        """Eliminate, pack, ONE fused dispatch, resolve per round."""
        track = self._track
        rounds = []
        futures = []                   # per round: surviving extract futs
        served = []                    # per round: (future, value) pairs
        min_lb = track["min_lb"]
        for window in rounds_ops:
            ext = [p for ins, p in window if not ins]
            vals = [p for ins, p in window if ins]
            if self.eliminate:
                pair_vals, rest_ins, rest_ne = eliminate_pq_pairs(
                    len(ext), vals, min_lb)
            else:
                pair_vals, rest_ins, rest_ne = [], sorted(vals), len(ext)
            served.append(list(zip(ext, pair_vals)))
            futures.append(ext[len(pair_vals):])
            rounds.append((rest_ne, rest_ins))
            # pessimistic in-flight bound: inserts can only lower the min,
            # extraction only raises it — keeping the old lb stays valid
            if rest_ins:
                min_lb = min(min_lb, rest_ins[0])
        self.eliminated += sum(len(s) for s in served)
        # per-window pair counts of the last call (test instrumentation:
        # lets the linearizability replay know the claimed matching)
        self.last_window_pairs = [len(s) for s in served]
        if any(ne or ins for ne, ins in rounds):
            handles = self.pq.apply_rounds_async(rounds)
            self.dispatches += 1
        else:
            handles = [None] * len(rounds)
        self.rounds += len(rounds)
        for (ne, ins), handle, fs, sv in zip(rounds, handles, futures,
                                             served):
            for f, v in sv:
                if not f.done():
                    f.set_result(v)
            res = handle.result() if handle is not None and ne else []
            # exact tracking per consumed round (the shared rule)
            track_pq_batch(track, res, ne, ins)
            for f, v in zip(fs, res):
                if not f.done():
                    f.set_result(v)


class AdaptivePQ:
    """Tier-routed batched PQ (DESIGN.md §14): same strict batch contract
    as the device engines (``apply(ne, ins)`` — extracts observe the
    pre-batch multiset, then inserts land), executable on either tier.

    * **host** — served from an eager :class:`SequentialHeap` mirror;
      the device falls behind, tracked as a multiset snapshot of its
      last-synced content (``_dev_content``).
    * **device** — one NET-EFFECT sync round plus the current batch fuse
      into ONE ``apply_rounds`` dispatch.  The sync round is exact, not
      a heuristic: a host window only ever extracts the CURRENT global
      minimum, so the old-content elements it removes are always a
      prefix of the sorted old content — any run of host windows
      therefore nets to ``(ne=|old∖new|, ins=new∖old)`` under the
      extracts-first batch contract.  Sync cost is O(churn), not
      O(windows served): a thousand host passes cost the same one round
      as ten (the PQ twin of the map/graph dedup-chain compaction).

    The mirror is *eager*: every apply updates it, so ``min_key()`` is the
    EXACT current minimum at zero device syncs — the elimination pre-pass
    upgrade over the conservative ``track_pq_batch`` bound.  ``values()``
    flushes the log and reads the DEVICE, so differential tests compare
    real device state, not the mirror answering for itself.

    Elimination is not expressible under this batch contract (it answers
    extracts with the batch's own inserts — a different, engine-level-only
    linearization), so a routed ``eliminate`` tier coerces to device here;
    the engine-level combiner (:func:`pc_adaptive_priority_queue`) owns
    that tier.
    """

    def __init__(self, pq: AnyBatchedPQ, *, router: TierRouter = None):
        self.pq = pq
        self.c_max = pq.c_max
        self.router = router or TierRouter(
            "pq", tiers=(TIER_HOST, TIER_DEVICE))
        self._mirror = SequentialHeap()
        for v in pq.values():       # one sync at construction, like track
            self._mirror.insert(v)
        # device multiset at the last sync; None ⇔ device == mirror
        self._dev_content: Optional[List[float]] = None
        self.flushes = 0
        self.absorbed = 0       # host windows folded into sync rounds

    def __len__(self) -> int:
        return len(self._mirror)

    def min_key(self) -> float:
        """Exact current minimum (host mirror; no device sync)."""
        return self._mirror.a[1] if self._mirror.size else math.inf

    def _sync_rounds(self):
        """Net-effect rounds taking the device from its last-synced
        content to the current mirror (see class docstring for why the
        prefix property makes this exact).  Extracts and inserts go in
        SEPARATE rounds: ``expand_rounds`` slices an oversized round
        with extracts and inserts advancing together, so a fused
        ``(ne, ins)`` round would let a later slice's extracts consume
        the sync's own inserts — pure rounds slice into pure rows and
        the all-extracts-then-all-inserts order survives any width."""
        dev = Counter(self._dev_content)
        mir = Counter(self._mirror.a[1:])
        ne = sum((dev - mir).values())
        ins = [k for k, c in (mir - dev).items() for _ in range(c)]
        return ([(ne, [])] if ne else []) + ([(0, ins)] if ins else [])

    def _flush(self):
        """Bring the device current with ONE net-effect dispatch.  An
        occupancy refusal is atomic, so the snapshot survives a raise."""
        if self._dev_content is not None:
            sync = self._sync_rounds()
            if sync:
                self.pq.apply_rounds(sync)          # raises → kept
            self._dev_content = None
            self.flushes += 1

    def values(self):
        self._flush()
        return self.pq.values()

    def apply(self, ne: int, ins, tier: str = None, observe: bool = None):
        """Batch apply, routed.  ``tier=None`` asks the router (and times
        the pass); an explicit tier is an external decision — the caller
        owns timing unless it passes ``observe=True``."""
        ins = [_quantize_key(v) for v in ins]
        width = ne + len(ins)
        if width == 0:
            return []
        if tier is None:
            tier = self.router.choose(width)
            if observe is None:
                observe = True
        if tier == TIER_ELIMINATE:
            tier = TIER_DEVICE          # see class docstring
        ctx = (self.router.timed(tier, width) if observe
               else contextlib.nullcontext())
        with ctx:
            if tier == TIER_HOST:
                if self._dev_content is None:
                    # first host window since sync: device == mirror, so
                    # snapshot the shared content BEFORE diverging
                    self._dev_content = list(self._mirror.a[1:])
                res = [self._mirror.extract_min() for _ in range(ne)]
                for v in ins:
                    self._mirror.insert(v)
                self.absorbed += 1
                return res
            rounds = [(ne, list(ins))]
            if self._dev_content is not None:
                rounds = self._sync_rounds() + rounds
            out = self.pq.apply_rounds(rounds)    # raises → state unchanged
            if self._dev_content is not None:
                self._dev_content = None
                self.flushes += 1
            for _ in range(ne):                   # keep the mirror eager
                self._mirror.extract_min()
            for v in ins:
                self._mirror.insert(v)
            return out[-1]

    @property
    def tier_decisions(self):
        return self.router.tier_decisions


def pc_adaptive_priority_queue(pq: AnyBatchedPQ, *, tier: str = "auto",
                               router: TierRouter = None,
                               **kw) -> ParallelCombiner:
    """Adaptive-tier parallel-combining PQ engine (DESIGN.md §14).

    Per combining pass the router picks host / eliminate / device; the
    whole pass (including any flush it triggers) is timed under the chosen
    tier so switching costs are charged to the tier that incurs them.
    ``tier`` pins a static tier (the ``--tier`` override); ``auto`` routes.

    The eliminate tier reuses the §12 pre-pass but against the mirror's
    EXACT minimum (not the conservative tracked bound), so every provably
    eliminable pair is caught; survivors take the device path inside the
    same timed window.
    """
    force = None if tier in (None, "auto") else str(tier)
    if router is None:
        router = TierRouter("pq", ALL_TIERS, force=force)
    apq = pq if isinstance(pq, AdaptivePQ) else AdaptivePQ(pq, router=router)

    def combiner_code(engine: ParallelCombiner, requests: List[Request]) -> None:
        extracts = [r for r in requests if r.method == "extract_min"]
        inserts = [r for r in requests if r.method == "insert"]
        ins_vals = [_quantize_key(r.input) for r in inserts]
        width = len(requests)
        t = router.choose(width, 0.0)
        with router.timed(t, width, 0.0, n_ops=max(1, width)):
            if t == TIER_ELIMINATE:
                served, rest_ins, rest_ne = eliminate_pq_pairs(
                    len(extracts), ins_vals, apq.min_key())
                engine.eliminated += len(served)
                for r, v in zip(extracts, served):
                    r.res = v
                    r.status = Status.FINISHED
                res = apq.apply(rest_ne, rest_ins, tier=TIER_DEVICE)
                rest_extracts = extracts[len(served):]
            else:
                res = apq.apply(len(extracts), ins_vals, tier=t)
                rest_extracts = extracts
            for r, v in zip(rest_extracts, res):
                r.res = v
                r.status = Status.FINISHED
            for r in inserts:
                r.res = None
                r.status = Status.FINISHED

    def client_code(engine: ParallelCombiner, r: Request) -> None:
        return

    def prewarm(widths=(1, 2, 4, 8, 16)):
        """Complete the router's cold start (and the jit warmup) for
        every width bucket before the measured/served workload.

        Cold-start probes are one-time costs, but they surface WHEREVER
        a context first occurs — possibly mid-run, where one device
        dispatch can dominate a short measurement window.  This runs the
        ``explore_min`` probes per (tier, width bucket) eagerly, using
        net-zero op pairs: insert ``w`` keys at/below the current min,
        then extract ``w`` — the multiset is unchanged (ties extract an
        equal key), every tier's real path runs, and the model sees a
        representative per-op dispatch cost.  No-op when already warm
        (sample counts persist), so calling it twice is free."""
        lk = apq.min_key()
        low = _quantize_key(lk - 1.0) if math.isfinite(lk) else 0.0
        seen = set()
        for w in widths:
            w = max(1, min(int(w), apq.c_max))
            b = CostModel.width_bucket(w)
            if b in seen:
                continue
            seen.add(b)
            lows = [low] * w
            for t in router.tiers:
                key = router.model.key("pq", t, w, 0.0)
                while router.model.samples(key) < router.explore_min:
                    if t == TIER_ELIMINATE:
                        with router.timed(t, w, 0.0, n_ops=2 * w):
                            eliminate_pq_pairs(w, lows, apq.min_key())
                            apq.apply(0, lows, tier=TIER_DEVICE)
                            apq.apply(w, [], tier=TIER_DEVICE)
                    else:
                        with router.timed(t, w, 0.0, n_ops=2 * w):
                            apq.apply(0, lows, tier=t)
                            apq.apply(w, [], tier=t)

    engine = ParallelCombiner(combiner_code, client_code, **kw)
    engine.eliminated = 0
    engine.router = router
    engine.tier_decisions = router.tier_decisions
    engine.adaptive_pq = apq
    engine.prewarm = prewarm
    return engine


def pc_sharded_priority_queue(capacity: int, c_max: int,
                              n_shards: int = 4, values=None,
                              donate: bool = True, fault_plan=None,
                              guard=None, device=None,
                              **kw) -> ParallelCombiner:
    """Parallel combining over the K-sharded batched heap (DESIGN.md §9).

    Same combiner protocol as :func:`pc_priority_queue` — the combined
    batch is split into E/I and applied as ONE K-shard pass via
    ``ShardedBatchedPQ.apply``.  ``donate=False`` is the clone-per-pass
    ablation (DESIGN.md §10).  ``fault_plan``/``guard`` thread the
    DESIGN.md §15 fault-tolerance layer through both the queue
    (transactional dispatch) and the combining engine (lease takeover,
    injected kills).  ``device=None`` means the card.
    """
    if fault_plan is not None:
        kw.setdefault("fault_plan", fault_plan)
    return pc_priority_queue(
        ShardedBatchedPQ(capacity, c_max=c_max, n_shards=n_shards,
                         values=values, donate=donate,
                         fault_plan=fault_plan, guard=guard,
                         device=device), **kw)


def pc_megapass_priority_queue(capacity: int, c_max: int,
                               n_shards: int = 4, values=None,
                               donate: bool = True, rounds_cap: int = 8,
                               use_megapass: bool = True, device=None):
    """Async megapass PQ engine (DESIGN.md §17): a
    :class:`~repro_torch.core.read_opt.MegapassCombiner` command queue over
    the K-sharded heap — insert/extract_min update rounds interleaved with
    peek_min read rounds, up to ``rounds_cap`` rounds per
    ``mixed_rounds`` dispatch: the rounds lower onto packed device rows,
    one CUDA-graph replay a dispatch on the card.  ``use_megapass=False``
    is the alternating twin (one dispatch a round).  ``device=None``
    means the card."""
    from .read_opt import MegapassCombiner

    return MegapassCombiner(
        ShardedBatchedPQ(capacity, c_max=c_max, n_shards=n_shards,
                         values=values, donate=donate, device=device),
        rounds_cap=rounds_cap, use_megapass=use_megapass)


def fc_priority_queue(**kw) -> ParallelCombiner:
    """Flat-combining binary heap (the paper's FC Binary baseline)."""
    from .flat_combining import flat_combining

    return flat_combining(SequentialHeap(), **kw)
