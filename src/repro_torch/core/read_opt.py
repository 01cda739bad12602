"""Read-dominated transform (paper §3.3): updates sequential, reads parallel.

The port of ``repro.core.read_opt``.  Two realizations:

* ``read_optimized_combining`` — the Listing-2/3-faithful host tier: the
  combiner applies updates sequentially, flips read requests to STARTED,
  executes its own read, and waits; each *client thread* executes its own
  read (CLIENT_CODE) and flips itself to FINISHED.

* ``BatchedReadOptimized`` — the device tier (DESIGN.md §2): the
  "clients" are vector lanes.  The combiner applies the update list
  sequentially, then answers the whole read list with ONE vectorized device
  pass (``read_batch``).  This is the variant the dynamic-graph and
  union-find workloads use: free cycles = GPU lanes instead of spinning
  threads.

  Data structures that expose ``update_batch_async`` (the device-resident
  ``DeviceGraph``, DESIGN.md §11) get their update list applied as batched
  combining passes too, with the result masks left on the device until the
  read batch's one blocking fetch.

The adaptive tier (``AdaptiveReadWrite``) differs from the reference in
one place: for a structure whose update batch answers under a pre-batch
snapshot rule (``batch_snapshot``, the union-find), the replay of
host-served ops keeps its own batch boundary instead of fusing into the
next device batch, so the answers equal the sequential oracle's.
"""
from __future__ import annotations

import contextlib
from typing import Any, List, Optional, Protocol, Sequence, Set, Tuple

from . import substrate
from .combining import (TIER_DEVICE, TIER_ELIMINATE, TIER_HOST,
                        ParallelCombiner, Request, RequestFailure, Status,
                        TierRouter)


class ReadWriteDS(Protocol):
    read_only: Set[str]

    def apply(self, method: str, input: Any) -> Any:  # pragma: no cover
        ...


def read_optimized_combining(ds: ReadWriteDS, **kw) -> ParallelCombiner:
    """Faithful §3.3 transform (Listings 2 and 3)."""

    def is_update(method: str) -> bool:
        return method not in ds.read_only

    def combiner_code(engine: ParallelCombiner, requests: List[Request]) -> None:
        updates = [r for r in requests if is_update(r.method)]
        reads = [r for r in requests if not is_update(r.method)]
        # updates: sequential (Listing 2, lines 11-13)
        for r in updates:
            r.res = ds.apply(r.method, r.input)
            r.status = Status.FINISHED
        # reads: release the clients (lines 15-16)
        for r in reads:
            r.status = Status.STARTED
        # the combiner's own request may be a read (lines 18-20)
        own = engine._record().request
        if any(r is own for r in reads) and own.status == Status.STARTED:
            own.res = ds.apply(own.method, own.input)
            own.status = Status.FINISHED
        # wait until every read is done (lines 22-23) — the combiner is
        # alive while parked here, so it heartbeats the lease
        for r in reads:
            engine.wait_while(r, Status.STARTED, heartbeat=True)

    def client_code(engine: ParallelCombiner, r: Request) -> None:
        if is_update(r.method):
            return                      # already FINISHED by the combiner
        r.res = ds.apply(r.method, r.input)
        r.status = Status.FINISHED

    return ParallelCombiner(combiner_code, client_code, **kw)


class BatchedReadDS(Protocol):
    read_only: Set[str]

    def apply(self, method: str, input: Any) -> Any:  # pragma: no cover
        ...

    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:  # pragma: no cover
        ...


def batched_read_optimized(ds: BatchedReadDS, *, use_megapass: bool = False,
                           **kw) -> ParallelCombiner:
    """Device-tier §3.3: the read batch is one vectorized device pass.

    ``use_megapass`` (DESIGN.md §17): when the structure exposes
    ``mixed_rounds``, an epoch's updates AND reads lower onto ONE
    dispatch — an update round followed by a read round with one shared
    fetch — instead of the alternating update-dispatch / read-dispatch
    pair.  The epoch boundary is preserved exactly: the read round runs
    after the update round, so a read collected in epoch E observes ALL
    of epoch E's updates, including the ones whose result masks are still
    on the device (they resolve through the megapass's shared fetch)."""

    use_mp = bool(use_megapass) and hasattr(ds, "mixed_rounds")

    def is_update(method: str) -> bool:
        return method not in ds.read_only

    def resolve_handle(handle, updates: List[Request]) -> None:
        for r, res in zip(updates, handle.result()):
            if r.status != Status.FINISHED:
                r.res = res
                r.status = Status.FINISHED

    def combiner_code(engine: ParallelCombiner, requests: List[Request]) -> None:
        updates = [r for r in requests if is_update(r.method)]
        reads = [r for r in requests if not is_update(r.method)]
        # adaptive tier hook (DESIGN.md §14): one routing decision — and
        # one cost-model observation — covers the WHOLE pass, so flush
        # costs are charged to the tier that triggered them
        pin = getattr(ds, "pin_tier", None)
        if pin is not None:
            pin(len(updates), len(reads))
        handle = None
        try:
            if use_mp and updates and hasattr(ds, "update_batch_async"):
                # megapass epoch (DESIGN.md §17): update round + read
                # round in ONE dispatch; every handle shares one fetch
                rounds = [("update", [r.method for r in updates],
                           [r.input for r in updates])]
                if reads:
                    rounds.append(("read", [r.method for r in reads],
                                   [r.input for r in reads]))
                hs = ds.mixed_rounds(rounds)
                engine.megapass_dispatches += 1
                engine.megapass_rounds += len(rounds)
                handle = hs[0]
                if reads:
                    for r, res in zip(reads, hs[1].result()):
                        r.res = res
                        r.status = Status.FINISHED
                resolve_handle(handle, updates)
                return
            if updates and hasattr(ds, "update_batch_async"):
                # device-resident tier (DESIGN.md §11): the whole update
                # list is dispatched as fused combining passes (arrival
                # order preserved) with the result masks left ON DEVICE —
                # they ride the read batch's single blocking fetch below
                handle = ds.update_batch_async(
                    [r.method for r in updates],
                    [r.input for r in updates])
            else:
                for r in updates:
                    r.res = ds.apply(r.method, r.input)
                    r.status = Status.FINISHED
            if reads:
                results = ds.read_batch([r.method for r in reads],
                                        [r.input for r in reads])
                for r, res in zip(reads, results):
                    r.res = res
                    r.status = Status.FINISHED
            if handle is not None:
                resolve_handle(handle, updates)
        except BaseException as exc:
            # one bad request (e.g. an invalid key) must not poison the
            # pass: updates that already reached the structure still get
            # their true results, and every other collected request is
            # FINISHED with a RequestFailure (re-raised on its owner's
            # thread) — a request left PUSHED here would be re-collected
            # and silently RE-APPLIED by a later pass
            if handle is not None:
                try:
                    resolve_handle(handle, updates)
                except BaseException:
                    pass
            for r in requests:
                if r.status != Status.FINISHED:
                    r.res = RequestFailure(exc)
                    r.status = Status.FINISHED
        finally:
            if pin is not None:
                ds.release_tier()

    def client_code(engine: ParallelCombiner, r: Request) -> None:
        return  # lanes did the work; nothing left for the thread

    engine = ParallelCombiner(combiner_code, client_code, **kw)
    engine.ds = ds      # the structure it combines over (as MegapassCombiner)
    return engine


# canonical name for the device tier (see module docstring)
BatchedReadOptimized = batched_read_optimized


class MegapassCombiner:
    """Async megapass combining engine (DESIGN.md §17) — the mixed
    update+read counterpart of ``pc_pq.AsyncRoundsPQ``'s command queue.

    Clients publish ops non-blockingly (:meth:`submit` returns a
    ``concurrent.futures`` future; :meth:`execute` blocks on it).  A
    dedicated combiner thread drains the backlog into alternating
    same-kind runs (split on ``ds.read_only``), packs each run into
    rounds of ≤ c_max ops, and lowers up to ``rounds_cap`` rounds onto
    ONE ``mixed_rounds`` dispatch — R adaptive from the backlog; the
    leftover stays queued for the next drain.  Linearization: ops in one
    round are concurrent (their combining round), rounds are sequential
    — and a read round observes every earlier round's updates, because
    it runs after them on the same stream.

    ``use_megapass=False`` is the alternating-dispatch ablation twin:
    the same drain loop, but every round goes out as its own device
    program (the base-class ``mixed_rounds`` fallback), so the pair
    isolates exactly the dispatch-fusion effect the §Megapass ablation
    measures.

    Instrumentation matches the sync engines: ``megapass_dispatches``
    (device programs), ``megapass_rounds`` (combining rounds executed),
    ``rounds_per_dispatch`` (their ratio — the amortization factor).
    """

    def __init__(self, ds, *, rounds_cap: int = 8,
                 use_megapass: bool = True):
        import threading
        from collections import deque

        self.ds = ds
        self.rounds_cap = max(1, int(rounds_cap))
        self.use_megapass = bool(use_megapass)
        self._ops = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.megapass_dispatches = 0
        self.megapass_rounds = 0
        self._thread = threading.Thread(target=self._loop,
                                        name="pc-megapass", daemon=True)
        self._thread.start()

    @property
    def rounds_per_dispatch(self) -> float:
        return (self.megapass_rounds / self.megapass_dispatches
                if self.megapass_dispatches else 0.0)

    # -- client side --------------------------------------------------------
    def submit(self, method: str, input: Any = None):
        """Publish one op; returns a future for its answer."""
        from concurrent.futures import Future

        f: "Future" = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("combiner is closed")
            self._ops.append((method, input, f))
            self._cond.notify()
        return f

    def execute(self, method: str, input: Any = None) -> Any:
        """Blocking :meth:`submit` (the sync-engine ``apply`` twin)."""
        return self.submit(method, input).result()

    def close(self) -> None:
        """Drain every published op, then stop the combiner thread."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join()

    def __enter__(self) -> "MegapassCombiner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- combiner side ------------------------------------------------------
    def _collect(self):
        """Pack the backlog head into ≤ rounds_cap alternating same-kind
        rounds of ≤ c_max ops each (called under the condition lock)."""
        c_max = int(getattr(self.ds, "c_max", 64))
        rounds: List[Tuple[str, List[str], List[Any]]] = []
        futs: List[List[Any]] = []
        while self._ops:
            m, i, f = self._ops[0]
            kind = "read" if m in self.ds.read_only else "update"
            if rounds and rounds[-1][0] == kind \
                    and len(rounds[-1][1]) < c_max:
                self._ops.popleft()
                rounds[-1][1].append(m)
                rounds[-1][2].append(i)
                futs[-1].append(f)
            elif len(rounds) < self.rounds_cap:
                self._ops.popleft()
                rounds.append((kind, [m], [i]))
                futs.append([f])
            else:
                break                  # budget spent: leftover stays queued
        return rounds, futs

    def _dispatch(self, rounds, futs) -> None:
        if self.use_megapass:
            handles = self.ds.mixed_rounds(rounds)
            self.megapass_dispatches += 1
        else:
            # alternating ablation twin: one device program per round
            handles = substrate.BatchedStructure.mixed_rounds(
                self.ds, rounds)
            self.megapass_dispatches += len(rounds)
        self.megapass_rounds += len(rounds)
        for h, fs in zip(handles, futs):
            for f, v in zip(fs, h.result()):
                if not f.done():
                    f.set_result(v)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and not self._ops:
                    self._cond.wait()
                if self._closed and not self._ops:
                    return
                rounds, futs = self._collect()
            try:
                self._dispatch(rounds, futs)
            except BaseException as exc:
                for fs in futs:
                    for f in fs:
                        if not f.done():
                            f.set_exception(exc)


# ---------------------------------------------------------------------------
# Adaptive tier routing (DESIGN.md §14): host mirror + lazy two-log sync
# ---------------------------------------------------------------------------
class _DoneHandle:
    """Host-served update results behind the async-handle interface."""

    def __init__(self, res: List[Any]):
        self._res = res

    def result(self) -> List[Any]:
        return self._res


class _TailHandle:
    """Skips the prepended flush ops of a fused device dispatch."""

    def __init__(self, handle, skip: int):
        self._handle, self._skip = handle, skip

    def result(self) -> List[Any]:
        return self._handle.result()[self._skip:]


def _canon_map_op(method: str, input: Any) -> Any:
    """The exact f32 images the device map stores (DESIGN.md §7) — both
    tiers must see THEM, or a raw-f64 key would make routing semantic:
    the host mirror would store a key the device tier can't find."""
    import numpy as np

    from .sharded_pq import host_key

    def q(x: float) -> float:
        return host_key(float(np.float32(x)))

    if method in ("insert", "assign"):
        k, v = input
        return (q(k), float(np.float32(v)))
    if method in ("delete", "lookup"):
        return q(input)
    if method in ("range_count", "range_sum"):
        lo, hi = input
        return (q(lo), q(hi))
    return input                     # kth_smallest: integer rank


def _compact_map(log: List[Tuple[str, Any]],
                 host) -> List[Tuple[str, Any]]:
    """Map log compaction: collapse same-key chains to the final mirror
    state per key (the host knows it exactly via ``lookup``)."""
    chains: dict = {}                   # key → ops, first-seen order
    for m, i in log:
        k = i if m == "delete" else i[0]
        chains.setdefault(k, []).append((m, i))
    out: List[Tuple[str, Any]] = []
    for k, chain in chains.items():
        if len(chain) == 1:             # nothing to collapse
            out.extend(chain)
            continue
        v = host.lookup(k)
        if v is None:
            out.append(("delete", k))   # no-op when never present
        else:
            # upsert as insert-then-assign (covers both presences)
            out.append(("insert", (k, v)))
            out.append(("assign", (k, v)))
    return out


def _compact_graph(log: List[Tuple[str, Any]],
                   host) -> List[Tuple[str, Any]]:
    """Graph log compaction: the LAST op per edge class alone decides
    final presence."""
    last = {}
    for m, (u, v) in log:
        last[(min(u, v), max(u, v))] = (m, (u, v))
    return list(last.values())


class AdaptiveReadWrite:
    """Tier-routed read/write structure (DESIGN.md §14): a device-resident
    structure and a host mirror behind ONE ``apply``/``update_batch``/
    ``read_batch`` facade, with the router picking the executing tier per
    call (or per combining pass, via the :meth:`pin_tier` hook
    ``batched_read_optimized`` drives).

    Correctness is the lazy two-log sync: ``_dev_log`` holds ops the host
    served that the device has not seen, ``_host_log`` the reverse — at
    most one is ever non-empty.  A tier first replays the log that would
    make it stale (the device replay FUSES into the tier's own dispatch),
    so any per-call routing sequence observes one linearized history.
    Routing is a performance decision, never a semantic one.

    The device replay is compacted first — the dedup-chain elimination
    tier of DESIGN.md §14: the replay only has to reproduce the final
    state per touched key (per-op results were already answered by the
    mirror), which the mirror knows exactly, so arbitrary-length
    same-key chains collapse to ≤ 2 canonical ops (``eliminated_ops``
    counts the savings).

    ``host_ds`` must start state-equal to ``device_ds`` (the factories
    below guarantee it).
    """

    def __init__(self, device_ds, host_ds, *,
                 router: Optional[TierRouter] = None,
                 structure: Optional[str] = None):
        self.device = device_ds
        self.host = host_ds
        self.read_only: Set[str] = set(device_ds.read_only)
        if structure is None:
            structure = getattr(device_ds, "structure", "") or \
                ("map" if hasattr(host_ds, "lookup") else "graph")
        # registry-driven hooks (DESIGN.md §16): a registered structure
        # brings its own op canonicalization + log compaction; ad-hoc
        # structures fall back to the map/graph heuristics
        spec = substrate.try_get(structure)
        if spec is not None:
            self._canon = spec.canon
            self._compact_hook = spec.compact
        else:
            self._canon = (_canon_map_op if hasattr(host_ds, "lookup")
                           else lambda m, i: i)
            self._compact_hook = None
        self.router = router or TierRouter(
            structure, (TIER_HOST, TIER_DEVICE))
        # structures with batch-boundary semantics (DESIGN.md §16's
        # pre-batch snapshot rule) replay in a batch of their own
        self._replay_own_batch = bool(getattr(device_ds, "batch_snapshot",
                                              False))
        self._dev_log: List[Tuple[str, Any]] = []   # device missed these
        self._host_log: List[Tuple[str, Any]] = []  # host missed these
        self._pin = None            # (tier, width, read_frac, t0)
        self.flushes = 0            # device replays dispatched
        self.eliminated_ops = 0     # ops removed by dedup-chain compaction

    @property
    def tier_decisions(self):
        return self.router.tier_decisions

    # -- routing -------------------------------------------------------------
    def _choose(self, width: int, read_frac: float) -> str:
        t = self.router.choose(width, read_frac)
        # elimination is not a standalone tier here: dedup chains ride the
        # host tier's compacted log flush (class docstring)
        return TIER_HOST if t == TIER_ELIMINATE else t

    def pin_tier(self, n_upd: int, n_read: int) -> str:
        """Route a whole combining pass with ONE decision; the matching
        :meth:`release_tier` records its cost under that decision."""
        width = max(1, int(n_upd) + int(n_read))
        read_frac = n_read / width
        tier = self._choose(width, read_frac)
        self._pin = (tier, width, read_frac, self.router.clock())
        return tier

    def release_tier(self) -> None:
        if self._pin is None:
            return
        tier, width, read_frac, t0 = self._pin
        self._pin = None
        self.router.observe(tier, width, read_frac,
                            self.router.clock() - t0, n_ops=width)

    def _tier_for(self, width: int, read_frac: float):
        if self._pin is not None:       # pass-level decision + timing
            return self._pin[0], contextlib.nullcontext()
        t = self._choose(width, read_frac)
        return t, self.router.timed(t, width, read_frac)

    # -- log sync ------------------------------------------------------------
    def _replay_host(self) -> None:
        if self._host_log:
            log, self._host_log = self._host_log, []
            for m, i in log:            # results discarded: device answered
                self.host.apply(m, i)

    def _compact(self, log: List[Tuple[str, Any]]) -> List[Tuple[str, Any]]:
        """Collapse the replay log via the structure's registered
        compaction rule (DESIGN.md §16), else the map/graph heuristics."""
        if self._compact_hook is not None:
            return self._compact_hook(log, self.host)
        if hasattr(self.host, "lookup"):        # ordered map
            return _compact_map(log, self.host)
        return _compact_graph(log, self.host)

    def _flush_device(self) -> None:
        """Replay (compacted) host-served ops on the device.  The handle
        is dropped on purpose: results were already answered host-side,
        and the masks ride the next read pass's blocking fetch."""
        if not self._dev_log:
            return
        ops = self._compact(self._dev_log)
        self.device.update_batch_async([m for m, _ in ops],
                                       [i for _, i in ops])
        self.eliminated_ops += len(self._dev_log) - len(ops)
        self._dev_log = []
        self.flushes += 1

    # -- structure facade ----------------------------------------------------
    def update_batch_async(self, methods: Sequence[str],
                           inputs: Sequence[Any]):
        inputs = [self._canon(m, i) for m, i in zip(methods, inputs)]
        tier, ctx = self._tier_for(len(methods), 0.0)
        with ctx:
            if tier == TIER_HOST:
                self._replay_host()
                # prefer the host's native batch entry: structures with
                # batch-boundary semantics (the union-find's pre-batch
                # snapshot rule) answer identically on either tier only
                # when the host sees the same batches the device would
                if hasattr(self.host, "update_batch"):
                    res = self.host.update_batch(list(methods), inputs)
                else:
                    res = [self.host.apply(m, i)
                           for m, i in zip(methods, inputs)]
                self._dev_log.extend(zip(methods, inputs))
                return _DoneHandle(res)
            if self._replay_own_batch:
                # a pre-batch snapshot rule answers every op of a batch
                # against the batch-start state: the replay must END
                # before this batch starts, or a repeated op that the
                # host already applied would be answered against the
                # state before it (the reference's adaptive union-find
                # reports a repeated union(40, 41) True here)
                self._flush_device()
                handle = self.device.update_batch_async(list(methods),
                                                        inputs)
                self._host_log.extend(zip(methods, inputs))
                return handle
            # device: the pending replay fuses into THIS dispatch
            pend = self._compact(self._dev_log)
            handle = self.device.update_batch_async(
                [m for m, _ in pend] + list(methods),
                [i for _, i in pend] + list(inputs))
            if self._dev_log:
                self.eliminated_ops += len(self._dev_log) - len(pend)
                self._dev_log = []
                self.flushes += 1
            self._host_log.extend(zip(methods, inputs))
            return _TailHandle(handle, len(pend))

    def update_batch(self, methods: Sequence[str],
                     inputs: Sequence[Any]) -> List[Any]:
        return self.update_batch_async(methods, inputs).result()

    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        inputs = [self._canon(m, i) for m, i in zip(methods, inputs)]
        tier, ctx = self._tier_for(len(methods), 1.0)
        with ctx:
            if tier == TIER_HOST:
                self._replay_host()
                return self.host.read_batch(methods, inputs)
            self._flush_device()
            return self.device.read_batch(methods, inputs)

    def apply(self, method: str, input: Any = None) -> Any:
        if method in self.read_only:
            return self.read_batch([method], [input])[0]
        return self.update_batch([method], [input])[0]

    # -- per-op conveniences (lock/FC wrappers, fuzz machines) ---------------
    def insert(self, *a) -> Any:
        return self.apply("insert", a[0] if len(a) == 1 else tuple(a))

    def delete(self, *a) -> Any:
        return self.apply("delete", a[0] if len(a) == 1 else tuple(a))

    def connected(self, u: int, v: int) -> bool:
        return self.apply("connected", (u, v))

    def lookup(self, key: float) -> Any:
        return self.apply("lookup", key)

    # -- whole-state views (flush first so the DEVICE answers) ---------------
    def items(self):
        self._flush_device()
        return self.device.items()

    def edges(self):
        self._flush_device()
        return self.device.edges()

    def counters(self):
        self._flush_device()
        return self.device.counters()

    def labels(self):
        self._flush_device()
        return self.device.labels()


def adaptive_read_engine(device_ds, host_ds, *, structure: str,
                         tier: str = "auto",
                         router: Optional[TierRouter] = None,
                         **kw) -> ParallelCombiner:
    """§3.3 batched-read combining over a tier-routed structure.

    ``tier`` pins a static tier (``auto`` routes; ``eliminate`` coerces
    to host, whose log flush carries the dedup-chain elimination)."""
    force = None if tier in (None, "auto") else str(tier)
    if force == TIER_ELIMINATE:
        force = TIER_HOST
    if router is None:
        router = TierRouter(structure, (TIER_HOST, TIER_DEVICE),
                            force=force)
    ads = AdaptiveReadWrite(device_ds, host_ds, router=router,
                            structure=structure)
    engine = batched_read_optimized(ads, **kw)
    engine.router = router
    engine.tier_decisions = router.tier_decisions
    engine.adaptive_ds = ads
    return engine


def pc_adaptive_graph(n_vertices: int, *, edge_capacity: int = 4096,
                      c_max: int = 64, n_shards: int = 1,
                      use_pallas: bool = False, donate: bool = True,
                      tier: str = "auto",
                      router: Optional[TierRouter] = None, device=None,
                      **kw) -> ParallelCombiner:
    """Adaptive-tier dynamic-graph engine: ``DeviceGraph`` device tier,
    ``DynamicGraph`` host tier, both starting empty (state-equal).
    ``device=None`` means the card."""
    from .device_graph import DeviceGraph
    from .dynamic_graph import DynamicGraph

    return adaptive_read_engine(
        DeviceGraph(n_vertices, edge_capacity=edge_capacity, c_max=c_max,
                    n_shards=n_shards, use_pallas=use_pallas,
                    donate=donate, device=device),
        DynamicGraph(n_vertices, device=device), structure="graph",
        tier=tier, router=router, **kw)
