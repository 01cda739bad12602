"""Async parallel-combining continuous-batching scheduler (DESIGN.md §3, §9).

The port of ``repro.serving.scheduler``.  Decode serving is exactly the
paper's workload: many concurrent request streams share one structure
(the device batch slots / KV cache) and the system must choose between
fine-grained dispatch (one device program per request — the
"fine-grained locking" analogue) and combining.

The scheduler keeps the paper's *explicit synchronization* (one combiner,
batched application) on an async engine:

* ``submit_async`` is non-blocking and returns a ``concurrent.futures``
  future — the publication step is an O(1) append under a condition
  variable, no spinning;
* a **dedicated combiner loop** drains the publication buffer, orders the
  pending requests by deadline on the **K-sharded batched priority queue**
  (DESIGN.md §9 — inserts routed across shards, extraction is a K-way
  merge, run by the ``heap_kmin`` / ``heap_sift`` / ``heap_insert``
  kernels on the card) and hands the chosen batch to the device;
* the combiner is **pipelined** against the device: while device pass N is
  in flight, the combiner is already collecting and ordering pass N+1
  (a depth-1 handoff queue), so host-side ordering cost hides behind
  device compute;
* PQ passes are **sync-free** (DESIGN.md §10): an ordering pass is ONE
  ``apply_rounds_async`` dispatch whose results stay on the device until
  the first consumed round, which makes the pass's one blocking fetch;
* the PQ keys live in a **persistent key→request table**: unchosen
  requests simply *stay* in the device-resident PQ across passes — each
  key is inserted once and extracted once;
* an **elimination pre-pass** (DESIGN.md §12) serves new requests that
  provably undercut every resident key straight from the host — the
  publish (insert) and the pick (extractMin) annihilate before touching
  the device, so a drained queue costs ZERO PQ device work;
* **adaptive round batching** (DESIGN.md §12): when the backlog exceeds
  one device batch, the combiner asks the PQ for R = ⌈backlog/max_batch⌉
  (capped at ``rounds_cap``) extraction rounds in ONE fused
  ``apply_rounds_async`` dispatch — publish round + R extract rounds
  back to back with no host sync between them — and the R chosen batches
  are handed to the device loop back-to-back.

``SerialScheduler`` is the fine-grained baseline: every request dispatches
its own device program under a plain mutex (the "single global lock, no
combining" analogue) — the benchmark compares the two (EXPERIMENTS §Paper).

Differences from the reference's constructor:

* ``pq_use_pallas`` is dropped: the port has no kernel knob.  On the card
  the deadline PQ always runs the hand-written kernels, on the CPU their
  plain versions.
* ``pq_placement`` places the deadline PQ's shards (DESIGN.md §18) on a
  ``MeshPlacement`` of D ranks, one process a rank (the reference runs
  one controller over D devices).  Every rank builds the scheduler; the
  leader (mesh index 0) runs the combiner, its clients and the device
  step, and every other rank's scheduler is a follower: :meth:`follow`
  replays the leader's passes on the rank's rows of the deadline PQ.
* ``pq_donate`` becomes the port's ``donate=``: the PQ's pass updates the
  heap stack in place; False is the clone-per-pass twin.
* ``device`` (``None`` means the card, and raises without one; the tests
  pass ``"cpu"``) is handed to the deadline PQ.
"""
from __future__ import annotations

import heapq
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from ..core.combining import (ALL_TIERS, TIER_DEVICE, TIER_ELIMINATE,
                              TIER_HOST, TierRouter)
from ..core.faults import (CircuitBreaker, DispatchGuard, FaultPlan,
                           InjectedCombinerKill)
from ..core.placement import resolve_placement
from ..core.sharded_pq import ShardedBatchedPQ, host_key

_SENTINEL = object()


def _fail_future(f: Future, exc: BaseException) -> None:
    """Fail ``f`` unless already resolved.  The done() pre-check cannot
    be atomic against a concurrent ``cancel()`` — swallowing the
    InvalidStateError keeps that race from killing a worker loop."""
    try:
        if not f.done():
            f.set_exception(exc)
    except Exception:
        pass


def _resolve_future(f: Future, value: Any) -> None:
    """Resolve ``f`` unless already resolved (same race note as above)."""
    try:
        if not f.done():
            f.set_result(value)
    except Exception:
        pass


@dataclass
class BatchRequest:
    """One serving request: an input row + a deadline priority key."""

    inputs: Any                       # per-request input (np array row / dict)
    deadline: float = 0.0             # smaller = more urgent
    submitted_at: float = field(default_factory=time.monotonic)


@dataclass
class _Entry:
    """A published request inside the scheduler (request + its future)."""

    req: BatchRequest
    future: Future
    key: float = 0.0                  # f32-quantized deadline (PQ dtype)
    epoch: int = 0                    # per-entry id (exactly-once recovery)


class PCScheduler:
    """Async parallel-combining scheduler around a batched ``step_fn``.

    Args:
      step_fn: callable taking a list of request inputs (length ≤ max_batch)
        and returning a list of per-request outputs (a
        ``launch.serve.DecodeExecutor`` or ``StructureExecutor``); the
        scheduler is agnostic.
      max_batch: device batch capacity per combining pass.
      use_pq: order pending requests by deadline with the sharded batched
        PQ (True) or FIFO (False) — the PQ path exercises the paper's
        batched data structure inside the serving layer.
      pq_capacity: per-shard heap capacity of the deadline PQ.
      n_shards: shard count K of the deadline PQ.
      pipeline: overlap combiner-side collection/ordering of pass N+1 with
        the in-flight device step of pass N (depth-1 handoff).  False runs
        the device step inline on the combiner thread (debug mode).
      donate: update the deadline PQ's heap stack in place (default);
        False is the clone-per-pass ablation twin (EXPERIMENTS
        §Ablations).
      pq_placement: shard layout of the deadline PQ (DESIGN.md §18).
        None keeps the stacked default; a ``MeshPlacement`` places the K
        shards on its mesh and runs the passes' merges as collectives
        (``serve.py --mesh-shards``).  The combiner is one thread of one
        rank, the mesh's leader (index 0); on every other rank the
        scheduler starts no thread, refuses submits, and :meth:`follow`
        replays the leader's PQ passes (a takeover's rebuilt queue
        included) until the leader's :meth:`close`.
      rounds_cap: cap R on the adaptive multi-round fused dispatch
        (DESIGN.md §12) — one ordering pass may choose up to
        ``rounds_cap · max_batch`` requests (eliminated + extracted) and
        hand them off as up to ``rounds_cap`` device batches; it also
        bounds the priority-inversion window (requests arriving while the
        chosen batches drain cannot preempt them).
      tier: ordering execution tier (DESIGN.md §14).  ``eliminate`` (the
        default) runs the elimination pre-pass and sends survivors through
        the device PQ; ``device`` skips the pre-pass; ``host`` keeps
        survivors in a host-side staging pool and only touches the device
        PQ to drain keys already resident there; ``auto`` lets a
        :class:`TierRouter` pick per ordering pass from its online cost
        model (decisions in ``tier_decisions``).
      router: optional externally-owned ``TierRouter`` (shared cost
        model / injectable clock for tests); built internally when None.
      fault_plan: optional :class:`FaultPlan` (DESIGN.md §15).  Hooks the
        combiner loop (kill / latency-spike injection per ordering pass)
        and wraps the deadline PQ's device dispatch in a transactional
        :class:`DispatchGuard` whose circuit breaker also vetoes the
        device/eliminate ordering tiers (graceful degradation to host).
      supervise: run a supervisor thread that restarts a dead combiner
        loop and re-queues every unserved entry exactly once (per-entry
        epoch ids dedupe across all internal queues).
      device: the deadline PQ's device — ``None`` means the card
        (``"cuda"``) and raises without one; the tests pass ``"cpu"``.
    """

    def __init__(self, step_fn: Callable[[List[Any]], Sequence[Any]],
                 max_batch: int = 16, use_pq: bool = True,
                 pq_capacity: int = 1 << 16, n_shards: int = 4,
                 pipeline: bool = True, donate: bool = True,
                 pq_placement=None, rounds_cap: int = 4,
                 tier: str = "eliminate",
                 router: Optional[TierRouter] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 supervise: bool = True, device=None):
        pl = resolve_placement(pq_placement)
        # a follower rank replays the leader's passes (follow()) and runs
        # no thread of its own
        self.is_leader = not pl.is_mesh or pl.is_leader
        self.step_fn = step_fn
        self.max_batch = max_batch
        self.use_pq = use_pq
        self.pipeline = pipeline
        self.rounds_cap = max(1, int(rounds_cap))
        if tier not in ("auto",) + tuple(ALL_TIERS):
            raise ValueError(f"unknown tier {tier!r}")
        self.fault_plan = fault_plan
        self.takeovers = 0             # combiner-loop restarts (DESIGN.md §15)
        self.breaker: Optional[CircuitBreaker] = None
        self._next_epoch = 0
        self._inflight = 0             # device steps currently executing
        self._sched_passes = 0         # fault-probe pass counter
        if use_pq:
            pq_guard = None
            if fault_plan is not None:
                # one breaker shared between the PQ's dispatch guard and
                # the ordering-tier router: repeated dispatch failures
                # open it, which both trips the guard's fallback AND
                # degrades ordering to the host tier until a probe heals.
                self.breaker = CircuitBreaker()
                pq_guard = DispatchGuard(fault_plan, breaker=self.breaker)
            self._pq_ctor = dict(capacity=pq_capacity,
                                 c_max=min(max_batch, 64),
                                 n_shards=n_shards,
                                 donate=donate,
                                 placement=pq_placement,
                                 guard=pq_guard,
                                 device=device)
            self._pq = ShardedBatchedPQ(**self._pq_ctor)
            # a rebuilt PQ runs on the first one's collectives: under a
            # mesh no communicator starts again on the recovery path
            self._pq_ctor["comm"] = self._pq.comm
            # persistent key→request table: a key is inserted into the
            # device PQ exactly once and stays there until extracted
            self._table: Dict[float, Deque[_Entry]] = {}
            self._queued = 0           # keys currently resident in the PQ
            self._resident: List[float] = []   # lazy min-heap of PQ keys
            # host-tier staging pool: ordered entries NOT published to the
            # device PQ; re-merged into the next ordering pass
            self._staged: List[_Entry] = []
            self.router = router or TierRouter(
                "sched", ALL_TIERS,
                force=None if tier == "auto" else tier)
            self.tier_decisions = self.router.tier_decisions
            if self.breaker is not None:
                for t in (TIER_DEVICE, TIER_ELIMINATE):
                    self.router.attach_breaker(t, self.breaker)
        self._backlog: Deque[_Entry] = deque()   # FIFO-mode leftovers
        self._pending: Deque[_Entry] = deque()   # publication buffer
        self._cond = threading.Condition()
        self._closed = False
        # instrumentation
        self.batches: List[int] = []
        self.passes = 0
        self.eliminated = 0            # requests served without PQ work
        self.pq_dispatches = 0         # fused PQ programs dispatched
        self.pq_rounds = 0             # combining rounds those carried

        self._handoff: "queue.Queue[Any]" = queue.Queue(maxsize=1)
        self._combiner = threading.Thread(
            target=self._combiner_loop, name="pc-combiner", daemon=True)
        self._device: Optional[threading.Thread] = None
        self._supervisor: Optional[threading.Thread] = None
        if not self.is_leader:
            return
        if pipeline:
            self._device = threading.Thread(
                target=self._device_loop, name="pc-device", daemon=True)
            self._device.start()
        self._combiner.start()
        if supervise:
            self._supervisor = threading.Thread(
                target=self._supervisor_loop, name="pc-supervisor",
                daemon=True)
            self._supervisor.start()

    @property
    def rounds_per_dispatch(self) -> float:
        """Mean combining rounds per fused PQ dispatch (DESIGN.md §17
        amortization factor; 0.0 before the first dispatch)."""
        return (self.pq_rounds / self.pq_dispatches
                if self.pq_dispatches else 0.0)

    # -- public API ----------------------------------------------------------
    def submit_async(self, inputs: Any, deadline: float = 0.0) -> Future:
        """Non-blocking submit; returns a future for the request's output.

        Raises ``RuntimeError`` immediately after :meth:`close` — and,
        defensively, if the combiner thread is no longer alive (a request
        must never enqueue onto a dead combiner loop, where its future
        could hang forever)."""
        if not self.is_leader:
            raise RuntimeError(
                f"a follower scheduler (mesh index "
                f"{self._pq.placement.index}) takes no request: submit to "
                f"the leader, mesh index 0 (rank "
                f"{self._pq.placement.ranks[0]})")
        if deadline != deadline:        # reject NaN at the client boundary
            raise ValueError("deadline must not be NaN")
        f: Future = Future()
        ent = _Entry(BatchRequest(inputs=inputs, deadline=deadline), f)
        with self._cond:
            alive = self._combiner.is_alive() or (
                self._supervisor is not None and self._supervisor.is_alive())
            if self._closed or not alive:
                raise RuntimeError("scheduler is closed")
            ent.epoch = self._next_epoch
            self._next_epoch += 1
            self._pending.append(ent)
            self._cond.notify()
        return f

    def submit(self, inputs: Any, deadline: float = 0.0) -> Any:
        """Blocking submit from a session thread; returns the output."""
        return self.submit_async(inputs, deadline).result()

    def follow(self) -> None:
        """A follower rank: replay the leader's deadline-PQ passes on this
        rank's rows until the leader closes its scheduler (a queue the
        leader rebuilt after a takeover is followed in turn)."""
        if self.is_leader:
            raise RuntimeError("the leader's scheduler runs the combiner; "
                               "only a follower rank follows it")
        if self.use_pq:
            self._pq = self._pq.follow()
        self._closed = True

    def close(self) -> None:
        """Drain outstanding requests, then stop the worker threads.

        Every future submitted before ``close`` resolves by the time it
        returns: requests already collected are served, and anything
        still unserved when the workers stop (e.g. because a worker
        thread died) is failed with ``RuntimeError`` instead of leaving
        its caller hanging.  A concurrent second ``close`` waits for the
        shutdown to complete instead of returning early.  The first
        ``close`` closes a placed deadline PQ (its groups; on a mesh, the
        close ends the followers' :meth:`follow`).  On a follower it only
        marks the scheduler closed."""
        if not self.is_leader:
            self._closed = True
            return
        with self._cond:
            first = not self._closed
            self._closed = True
            self._cond.notify_all()
        if self._supervisor is not None:
            self._supervisor.join()
        # the supervisor may have replaced the combiner right up until it
        # observed _closed — join whichever thread holds the role now
        while True:
            c = self._combiner
            c.join()
            if c is self._combiner:
                break
        if self._device is not None:
            if first:
                self._handoff.put(_SENTINEL)
            self._device.join()
        # an in-flight device step must finish and resolve its futures
        # BEFORE the doomed-future sweep: close() must never fail a
        # request the device is about to answer.
        with self._cond:
            while self._inflight:
                self._cond.wait()
        # safety net: no caller may hang on a future we will never serve.
        # The workers are joined, but a CONCURRENT second close() runs
        # this same sweep — take the lock so the two don't race on the
        # queues/table (uncontended: submitters raise under it already).
        with self._cond:
            doomed = list(self._pending) + list(self._backlog)
            self._pending.clear()
            self._backlog.clear()
            if self.use_pq:
                for bucket in self._table.values():
                    doomed.extend(bucket)
                self._table.clear()
                doomed.extend(self._staged)
                self._staged = []
                self._queued = 0
                self._resident = []
        for ent in doomed:
            _fail_future(ent.future, RuntimeError(
                "scheduler closed before the request was served"))
        if first and self.use_pq:
            self._pq.close()           # a placed deadline PQ's groups

    def __enter__(self) -> "PCScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def mean_batch(self) -> float:
        return float(np.mean(self.batches)) if self.batches else 0.0

    # -- combiner loop -------------------------------------------------------
    def _has_leftovers(self) -> bool:
        if self.use_pq:
            return self._queued > 0 or bool(self._staged)
        return bool(self._backlog)

    def _combiner_loop(self) -> None:
        while True:
            with self._cond:
                while (not self._closed and not self._pending
                       and not self._has_leftovers()):
                    self._cond.wait()
                if (self._closed and not self._pending
                        and not self._has_leftovers()):
                    return
                new = list(self._pending)
                self._pending.clear()
            if self.fault_plan is not None:
                self._sched_passes += 1
                try:
                    self.fault_plan.on_combiner_pass(self._sched_passes)
                except InjectedCombinerKill:
                    # crash emulation: push the just-collected requests
                    # back unserved and die with them still queued — the
                    # supervisor re-queues everything exactly-once (epoch
                    # ids) and restarts the loop.
                    with self._cond:
                        self._pending.extendleft(reversed(new))
                    raise
            try:
                chosen_rounds = self._order(new)
            except BaseException as exc:
                # ordering failure must not kill the combiner silently:
                # fail every affected future (ordering state may be
                # inconsistent, so flush leftovers too) and keep serving
                self._abort_pending(new, exc)
                continue
            for chosen in chosen_rounds:
                self.passes += 1
                self.batches.append(len(chosen))
                if self.pipeline:
                    self._handoff.put(chosen)  # blocks at pipeline depth 1
                else:
                    self._run_batch(chosen)

    def _abort_pending(self, new: List[_Entry], exc: BaseException) -> None:
        doomed = list(new) + list(self._backlog)
        self._backlog.clear()
        if self.use_pq:
            for bucket in self._table.values():
                doomed.extend(bucket)
            self._table.clear()
            doomed.extend(self._staged)
            self._staged = []
            self._queued = 0
            self._resident = []
            # the device PQ may hold keys for the doomed requests (and be
            # mid-batch inconsistent) — rebuild it from scratch
            self._pq = ShardedBatchedPQ(**self._pq_ctor)
        for ent in doomed:
            _fail_future(ent.future, exc)

    # -- supervisor (DESIGN.md §15) ------------------------------------------
    def _supervisor_loop(self) -> None:
        while True:
            c = self._combiner
            c.join(timeout=0.05)
            with self._cond:
                if self._closed:
                    return
                if c.is_alive() or c is not self._combiner:
                    continue
            self._recover(c)

    def _recover(self, dead: threading.Thread) -> None:
        """Restart a dead combiner loop, re-queueing every unserved entry
        exactly once: entries are gathered from ALL internal queues (the
        publication buffer, the FIFO backlog, the key table and the host
        staging pool), deduped by per-entry epoch id, and replayed in
        submission order.  Entries whose future already resolved (e.g. an
        in-flight device step finished while the combiner was down) are
        skipped — a request is never applied twice."""
        with self._cond:
            if self._closed or self._combiner is not dead:
                return
            entries = list(self._pending) + list(self._backlog)
            self._pending.clear()
            self._backlog.clear()
            if self.use_pq:
                for bucket in self._table.values():
                    entries.extend(bucket)
                self._table.clear()
                entries.extend(self._staged)
                self._staged = []
                self._queued = 0
                self._resident = []
                # the device PQ may hold keys of recovered requests (and
                # may be mid-pass inconsistent) — rebuild it from scratch;
                # _pq_ctor carries the dispatch guard, so the rebuilt PQ
                # stays transactional under the active fault plan
                self._pq = ShardedBatchedPQ(**self._pq_ctor)
            seen: set = set()
            requeue: List[_Entry] = []
            for ent in sorted(entries, key=lambda e: e.epoch):
                if ent.epoch in seen or ent.future.done():
                    continue
                seen.add(ent.epoch)
                requeue.append(ent)
            self._pending.extend(requeue)
            self.takeovers += 1
            if self.fault_plan is not None:
                self.fault_plan.counters.bump("takeovers")
            self._combiner = threading.Thread(
                target=self._combiner_loop, name="pc-combiner", daemon=True)
            self._combiner.start()
            self._cond.notify_all()

    def fault_counters(self) -> Dict[str, Any]:
        """Robustness counters surfaced to ops layers (DESIGN.md §15)."""
        out: Dict[str, Any] = {"scheduler_takeovers": self.takeovers}
        if self.fault_plan is not None:
            out.update(self.fault_plan.counters.snapshot())
        if self.breaker is not None:
            out["breaker_state"] = self.breaker.state
        return out

    def _peek_resident(self) -> Optional[float]:
        """Smallest key still resident in the device PQ (lazy min-heap:
        keys whose table bucket drained are popped on the way)."""
        h = self._resident
        while h and h[0] not in self._table:
            heapq.heappop(h)
        return h[0] if h else None

    def _order(self, new: List[_Entry]) -> List[List[_Entry]]:
        """One ordering pass: up to ``rounds_cap`` most-urgent device
        batches (each ≤ max_batch), leftovers stay queued.

        Elimination pre-pass + fused rounds (DESIGN.md §12): new keys that
        undercut every resident key are chosen straight from the host —
        their insert and their extract annihilate, zero PQ device work
        (with nothing resident that is EVERY new request, the drained-
        queue steady state).  Whatever survives goes to the device as ONE
        ``apply_rounds_async`` dispatch: a publish round for the surviving
        new keys plus ⌈want/max_batch⌉ extraction rounds, back to back
        with one blocking fetch."""
        if not self.use_pq:
            self._backlog.extend(new)
            n = min(self.max_batch, len(self._backlog))
            return [[self._backlog.popleft() for _ in range(n)]] if n \
                else []
        # tier decision (DESIGN.md §14): ONE routing choice — and one
        # cost-model observation — per ordering pass
        width = len(new) + len(self._staged)
        t = self.router.choose(width, 0.0)
        with self.router.timed(t, width, 0.0, n_ops=max(1, width)):
            return self._order_tiered(new, t)

    def _order_tiered(self, new: List[_Entry],
                      tier: str) -> List[List[_Entry]]:
        budget = self.rounds_cap * self.max_batch
        # host_key applies the device's full key quantization (f32 +
        # flush-to-zero + finite clamp) so extracted keys hit the table.
        for ent in new:
            ent.key = host_key(ent.req.deadline)
        if self._staged:
            # host-tier staging pool: unpublished survivors of earlier
            # passes re-enter the ordering here (already quantized)
            new = new + self._staged
            self._staged = []
        new = sorted(new, key=lambda e: e.key)
        min_res = self._peek_resident()
        n_elim = 0
        if tier != TIER_DEVICE:          # device tier = no pre-pass
            while (n_elim < len(new) and n_elim < budget
                   and (min_res is None or new[n_elim].key <= min_res)):
                n_elim += 1
        elim, rest = new[:n_elim], new[n_elim:]
        self.eliminated += n_elim
        chosen: List[_Entry] = list(elim)
        if tier == TIER_HOST:
            # host tier: survivors stay OFF the device PQ (staged for the
            # next pass — they can't be served yet: their keys sit above
            # the device-resident minimum, or the pass budget is spent).
            # Device work only to drain keys already resident — that cost
            # is charged to the host decision, the natural switch penalty.
            self._staged = rest
            rest = []
            want = min(self._queued, budget - n_elim)
        else:
            want = min(self._queued + len(rest), budget - n_elim)
        if rest or want:
            # publish the surviving NEW keys only — everything already in
            # the device PQ stays there (persistent table; no re-insert
            # churn) — and extract the `want` most urgent, all in ONE
            # fused multi-round dispatch.
            for ent in rest:
                self._table.setdefault(ent.key, deque()).append(ent)
                heapq.heappush(self._resident, ent.key)
            self._queued += len(rest)
            rounds: List = [(0, [e.key for e in rest])] if rest else []
            n_ins_rounds = len(rounds)
            left = want
            while left > 0:
                ne = min(left, self.max_batch)
                rounds.append((ne, []))
                left -= ne
            try:
                handles = self._pq.apply_rounds_async(rounds)
            except ValueError as exc:
                # occupancy-guard refusal (the deadline PQ would overflow
                # a shard).  The refusal is ATOMIC on the PQ side —
                # nothing reached the device and the mirror is untouched
                # — so fail ONLY the new requests: resident entries, the
                # lazy min-heap and the device PQ stay exactly as they
                # were, and the next pass keeps draining them.  (The
                # heap may keep stale copies of the refused keys; the
                # lazy pop in _peek_resident discards keys whose table
                # bucket is gone.)
                for ent in rest:
                    bucket = self._table.get(ent.key)
                    if bucket is not None:
                        try:
                            bucket.remove(ent)
                        except ValueError:
                            pass
                        if not bucket:
                            del self._table[ent.key]
                    _fail_future(ent.future, exc)
                self._queued -= len(rest)
                return [chosen[i : i + self.max_batch]
                        for i in range(0, len(chosen), self.max_batch)]
            self.pq_dispatches += 1
            self.pq_rounds += len(rounds)
            lost = False
            for h in handles[n_ins_rounds:]:
                for k in h.result():    # first consume pays the one fetch
                    if k is None:
                        # the device PQ is empty though bookkeeping says
                        # otherwise — reconcile instead of livelocking,
                        # and fail any requests whose keys were lost
                        self._queued = 0
                        self._resident = []
                        stranded = [e for b in self._table.values()
                                    for e in b]
                        self._table.clear()
                        for ent in stranded:
                            _fail_future(ent.future, RuntimeError(
                                "deadline key lost from the device PQ"))
                        lost = True
                        break
                    self._queued -= 1
                    bucket = self._table.get(float(k))
                    if bucket is None:
                        continue    # stale key flushed by an abort
                    chosen.append(bucket.popleft())
                    if not bucket:
                        del self._table[float(k)]
                if lost:
                    break
        # eliminated keys undercut every resident key and both streams
        # are ascending — the concatenation is globally urgency-ordered
        return [chosen[i : i + self.max_batch]
                for i in range(0, len(chosen), self.max_batch)]

    # -- device side ---------------------------------------------------------
    def _device_loop(self) -> None:
        while True:
            batch = self._handoff.get()
            if batch is _SENTINEL:
                return
            self._run_batch(batch)

    def _run_batch(self, batch: List[_Entry]) -> None:
        with self._cond:
            self._inflight += 1
        try:
            outs = list(self.step_fn([e.req.inputs for e in batch]))
            for ent, out in zip(batch, outs):
                _resolve_future(ent.future, out)   # client may have cancelled
            if len(outs) < len(batch):
                # a short return must not strand the tail forever
                raise RuntimeError(
                    f"step_fn returned {len(outs)} outputs for a batch "
                    f"of {len(batch)}")
        except BaseException as exc:   # propagate to every waiting client
            for ent in batch:
                _fail_future(ent.future, exc)
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()


class SerialScheduler:
    """Fine-grained baseline: one device dispatch per request, mutex-guarded."""

    def __init__(self, step_fn: Callable[[List[Any]], Sequence[Any]]):
        self.step_fn = step_fn
        self._lock = threading.Lock()
        self.batches: List[int] = []

    def submit(self, inputs: Any, deadline: float = 0.0) -> Any:
        with self._lock:
            self.batches.append(1)
            return self.step_fn([inputs])[0]
