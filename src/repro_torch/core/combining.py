"""Parallel combining engine — faithful to Listing 1 of the paper.

The engine is parameterized (as in §3.1) by:

* ``combiner_code(engine, requests)``  — COMBINER_CODE
* ``client_code(engine, request)``     — CLIENT_CODE
* the request ``Status`` set (PUSHED / STARTED / SIFT / FINISHED)

Shared state mirrors the paper's ``FC`` record: a global lock, a combining
pass counter ``count`` and the ``head`` of the *publication list* — a linked
list of per-thread publication records.  A record that has not participated
in recent combining passes (``count - last`` large) is evicted during the
periodic ``cleanup`` (paper: every 1000th pass).

Hardware adaptation (see DESIGN.md §2): CPython has no CAS primitive, so the
``cas(FC.head, head, p)`` of Listing 1 is emulated with a dedicated mutex
(``_head_cas``); the global lock's try-acquire is
``threading.Lock.acquire(blocking=False)``.  Busy-wait loops yield the GIL
via ``time.sleep(0)`` so the host tier stays live on a single core.

Fault tolerance (DESIGN.md §15): the global lock doubles as a
heartbeat-stamped *lease*.  A spinning client whose combiner exceeds the
lease deadline takes the lock over (``threading.Lock`` release is legal
cross-thread) and retries as the combiner, so a combiner that dies
mid-protocol — emulated by ``FaultPlan.on_combiner_pass`` raising with
the lock still held — strands nobody.  ``wait_while`` is bounded the
same way.
"""
from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from enum import IntEnum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .faults import (CircuitBreaker, CombinerLeaseExpired, FaultPlan,
                     InjectedCombinerKill)


class Status(IntEnum):
    """STATUS_SET of the paper (§3.1, §3.3, §4)."""

    PUSHED = 0      # request is active, not yet picked up
    STARTED = 1     # read-dominated transform: combiner released the read
    SIFT = 2        # batched heap: client must run its sift/insert phase
    FINISHED = 3    # request served; ``res`` is valid


class RequestFailure:
    """Sentinel response: the combiner could not serve this request.

    A combiner pass serves MANY clients; an exception mid-pass (e.g. an
    invalid input published by one of them) must not leave the others'
    requests PUSHED — a later pass would silently re-apply an update
    that already reached the structure.  Combiner codes that batch
    against a fallible backend FINISH the affected requests with a
    ``RequestFailure`` instead; :meth:`ParallelCombiner.execute`
    re-raises the wrapped error on the owning client's thread."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


@dataclass
class Request:
    """A published request (method + input + status + response + aux)."""

    method: Optional[str] = None
    input: Any = None
    status: Status = Status.FINISHED
    res: Any = None
    # auxiliary fields used by the batched-PQ application (§4)
    start: int = 0          # id of the node the client starts its phase from
    aux: Any = None


class PublicationRecord:
    __slots__ = ("next", "request", "last", "owner", "in_list")

    def __init__(self, owner: int = -1):
        self.next: Optional["PublicationRecord"] = None
        self.request = Request()
        self.last = 0            # id of the last combining pass that served us
        self.owner = owner
        self.in_list = False


class ParallelCombiner:
    """The parameterized parallel-combining engine (Listing 1)."""

    def __init__(
        self,
        combiner_code: Callable[["ParallelCombiner", List[Request]], None],
        client_code: Callable[["ParallelCombiner", Request], None],
        cleanup_every: int = 1000,
        age_limit: int = 2000,
        *,
        lease_timeout: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        fault_plan: Optional[FaultPlan] = None,
    ):
        self.combiner_code = combiner_code
        self.client_code = client_code
        self.cleanup_every = cleanup_every
        self.age_limit = age_limit

        self.lock = threading.Lock()              # the global lock
        self.count = 0                            # combining pass counter
        self.head: Optional[PublicationRecord] = None
        self._head_cas = threading.Lock()         # CAS emulation on ``head``
        self._tls = threading.local()
        # combiner lease (DESIGN.md §15): _heartbeat is stamped under
        # _takeover_lock whenever the combiner proves liveness (lock
        # acquire, wait_while parks) and reset to None on release, so
        # the acquire→stamp window can never look expired.  A takeover
        # bumps _lease_epoch; a combiner only releases the lock if its
        # epoch is still current (the lock belongs to the usurper
        # otherwise).  lease_timeout must exceed the worst-case
        # combining pass — expiry is only *declared* while the combiner
        # is parked at a checkpoint (pass entry, wait_while).
        self.lease_timeout = float(lease_timeout)
        self.clock = clock
        self.fault_plan = fault_plan
        self._takeover_lock = threading.Lock()
        self._heartbeat: Optional[float] = None
        self._lease_epoch = 0
        self.takeovers = 0
        # instrumentation
        self.passes = 0
        self.combined_sizes: List[int] = []
        # megapass instrumentation (DESIGN.md §17): fused mixed
        # update+read dispatches, and the combining rounds they carried
        self.megapass_dispatches = 0
        self.megapass_rounds = 0

    @property
    def rounds_per_dispatch(self) -> float:
        """Mean combining rounds per fused megapass dispatch (0.0 when
        no megapass was ever dispatched)."""
        return (self.megapass_rounds / self.megapass_dispatches
                if self.megapass_dispatches else 0.0)

    # -- publication list -------------------------------------------------
    def _record(self) -> PublicationRecord:
        rec = getattr(self._tls, "rec", None)
        if rec is None:
            rec = PublicationRecord(owner=threading.get_ident())
            self._tls.rec = rec
        return rec

    def _cas_head(self, expect: Optional[PublicationRecord],
                  new: PublicationRecord) -> bool:
        with self._head_cas:
            if self.head is expect:
                self.head = new
                return True
            return False

    def add_publication(self, p: PublicationRecord) -> None:
        """Listing 1, ``addPublication`` (lines 49-56)."""
        if p.in_list:
            return
        if self.fault_plan is not None and self.fault_plan.maybe_drop_record():
            # injected lost insert: the record never links; the owner's
            # spin loop re-publishes on its next iteration, so a dropped
            # record costs a retry, never an op
            return
        while True:
            head = self.head
            p.next = head
            p.in_list = True
            if self._cas_head(head, p):
                return

    def get_requests(self) -> List[Request]:
        """Listing 1, ``getRequests`` (lines 58-65): collect PUSHED requests."""
        node = self.head
        out: List[Request] = []
        while node is not None:
            if node.request.status == Status.PUSHED:
                out.append(node.request)
                node.last = self.count
            node = node.next
        return out

    def cleanup(self) -> None:
        """Listing 1, ``cleanup`` (lines 67-77): age-based record eviction.

        Only the combiner (lock holder) unlinks records; a removed record's
        owner re-adds it via ``add_publication`` on its next spin iteration.
        """
        prev = self.head
        if prev is None:
            return
        node = prev.next
        while node is not None:
            nxt = node.next
            if (
                self.count - node.last > self.age_limit
                and node.request.status == Status.FINISHED
            ):
                prev.next = nxt
                node.in_list = False
            else:
                prev = node
            node = nxt

    # -- combiner lease (DESIGN.md §15) -----------------------------------
    def _stamp(self) -> None:
        with self._takeover_lock:
            self._heartbeat = self.clock()

    def _lease_expired(self) -> bool:
        hb = self._heartbeat
        return (hb is not None and self.lock.locked()
                and self.clock() - hb > self.lease_timeout)

    def _try_takeover(self) -> bool:
        """Reclaim an expired lease: verified under ``_takeover_lock``,
        the usurper bumps the epoch (so the dead combiner's ``finally``
        won't double-release) and releases the abandoned global lock —
        cross-thread release is legal on ``threading.Lock``.  The caller
        then competes for the lock as an ordinary combiner candidate;
        the still-PUSHED requests are served by whoever wins."""
        with self._takeover_lock:
            if not (self._heartbeat is not None and self.lock.locked()
                    and self.clock() - self._heartbeat > self.lease_timeout):
                return False      # raced: lease refreshed or lock freed
            self._lease_epoch += 1
            self._heartbeat = None
            self.takeovers += 1
            if self.fault_plan is not None:
                self.fault_plan.counters.bump("takeovers")
            self.lock.release()
            return True

    # -- the execute protocol ---------------------------------------------
    def execute(self, method: str, input: Any = None) -> Any:
        """Listing 1, ``execute`` (lines 20-47)."""
        p = self._record()
        r = p.request
        r.method = method
        r.input = input
        r.res = None
        r.start = 0
        r.aux = None
        # the status field is initialized *last* (paper step 1)
        r.status = Status.PUSHED

        self.add_publication(p)
        while r.status != Status.FINISHED:
            if self.lock.acquire(blocking=False):
                with self._takeover_lock:
                    epoch = self._lease_epoch
                    self._heartbeat = self.clock()
                killed = False
                try:
                    # we are the combiner
                    self.add_publication(p)
                    self.count += 1
                    if self.fault_plan is not None:
                        try:
                            self.fault_plan.on_combiner_pass(self.count)
                        except InjectedCombinerKill as e:
                            # die mid-protocol: FINISH our own request as
                            # failed (it was never applied — the kill fires
                            # before get_requests), leave the lock HELD to
                            # emulate the crash, and propagate.  Clients
                            # spin until the lease expires, then take over.
                            r.res = RequestFailure(e)
                            r.status = Status.FINISHED
                            killed = True
                            raise
                        if self._lease_epoch != epoch:
                            # an injected latency spike outlived the lease
                            # and a client took the lock over — abandon the
                            # pass before touching any request
                            continue
                    requests = self.get_requests()
                    self.passes += 1
                    self.combined_sizes.append(len(requests))
                    self.combiner_code(self, requests)
                    if self.count % self.cleanup_every == 0:
                        self.cleanup()
                finally:
                    if not killed:
                        with self._takeover_lock:
                            if self._lease_epoch == epoch:
                                self._heartbeat = None
                                self.lock.release()
            else:
                # we are a client
                while r.status == Status.PUSHED and self.lock.locked():
                    self.add_publication(p)
                    if self._lease_expired():
                        self._try_takeover()
                        break      # retry as combiner candidate
                    time.sleep(0)  # GIL yield (spin-wait adaptation)
                if r.status == Status.PUSHED:
                    continue       # lock was released; retry as combiner
                self.client_code(self, r)
        if isinstance(r.res, RequestFailure):
            raise r.res.error      # surfaced on the owning client thread
        return r.res

    # helper for combiner/client codes that need to block on a status change
    def wait_while(self, request: Request, status: Status, *,
                   heartbeat: bool = False,
                   timeout: Optional[float] = None) -> None:
        """Bounded spin until ``request.status`` leaves ``status``.

        ``heartbeat=True`` is for the *combiner* parking while clients
        run their phase: it proves liveness by re-stamping the lease
        each iteration and is unbounded (the pass cannot complete
        without the clients).  Without it the caller is a *client*
        waiting on combiner progress: the wait is bounded by ``timeout``
        (default: the lease timeout) and raises
        :class:`~repro_torch.core.faults.CombinerLeaseExpired` instead of
        spinning forever on a dead combiner."""
        if heartbeat:
            while request.status == status:
                self._stamp()
                time.sleep(0)
            return
        bound = self.lease_timeout if timeout is None else float(timeout)
        t0 = self.clock()
        while request.status == status:
            if self.clock() - t0 > bound:
                raise CombinerLeaseExpired(
                    f"request stuck in {status.name} for >{bound:g}s "
                    f"(combiner presumed dead)")
            time.sleep(0)


# ---------------------------------------------------------------------------
# Elimination pre-pass (DESIGN.md §12) — host-side insert/extract matching
# ---------------------------------------------------------------------------
def eliminate_pq_pairs(extracts: int, inserts: List[float],
                       min_lb: float) -> Tuple[List[float], List[float], int]:
    """Match Insert/ExtractMin pairs that never need to touch the queue.

    All requests of one combining pass are concurrent, so the combiner may
    pick ANY linearization.  An ``insert(v)`` with ``v ≤ min_lb`` (a host
    lower bound on the queue's current minimum, ``min_lb ≤ true min``) can
    be linearized immediately before an ``extractMin``: the extract then
    returns exactly ``v`` and the queue is untouched — the pair is
    *eliminated* (Calciu et al.'s elimination rule, adapted to batch
    combining).  Chained pairs stay valid because each pair leaves the
    queue, and hence its minimum, unchanged.

    The remaining requests keep the engine's standard batch order (all
    surviving extracts see the pre-batch multiset, then the surviving
    inserts enter), giving the full linearization
    ``pair_1 … pair_e, extract^(E-e), insert^(I-e)``.

    Returns ``(served, rest_inserts, rest_extracts)``: the eliminated
    pair values ascending (one per matched extract), the surviving insert
    values, and the surviving extract count.
    """
    vals = sorted(inserts)
    e = 0
    while e < extracts and e < len(vals) and vals[e] <= min_lb:
        e += 1
    return vals[:e], vals[e:], extracts - e


# ---------------------------------------------------------------------------
# Adaptive tier routing (DESIGN.md §14) — online cost model + router
# ---------------------------------------------------------------------------
# Execution tiers a combining pass can route a collected batch to.  Not
# every structure offers all three: the PQ engine routes across all of
# them, the read-optimized structures (map, graph) fuse their
# elimination/dedup fast path INTO the device pass (DESIGN.md §12) and
# route host vs device only.
TIER_HOST = "host"            # sequential host mirror (seq_pq/seq_map/
#                               dynamic_graph) — zero device dispatches
TIER_ELIMINATE = "eliminate"  # host elimination pre-pass, survivors to
#                               the device rounds path
TIER_DEVICE = "device"        # fused device rounds path, no pre-pass

ALL_TIERS = (TIER_HOST, TIER_ELIMINATE, TIER_DEVICE)


class CostModel:
    """Online per-tier dispatch-cost model (DESIGN.md §14).

    Keeps an EWMA of the measured **seconds per operation** keyed by
    ``(structure, tier, batch-width bucket, read-fraction bucket)`` — the
    features the bench trajectories show the host/device crossover
    depends on (FC host map ~10-23k ops/s vs PC ~200-700 on small
    batches; the fused PQ rounds path 14x ahead on wide ones).  Width
    buckets are pow2 (a 3-op and a 4-op pass share a bucket, a 64-op
    pass does not) and the read fraction quantizes to quartiles, so a
    handful of passes is enough to cover a regime while distinct regimes
    never share a cell.
    """

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self._ewma: Dict[tuple, float] = {}
        self._n: Dict[tuple, int] = {}

    @staticmethod
    def width_bucket(width: int) -> int:
        """pow2 bucket index: 1→0, 2→1, 3-4→2, 5-8→3, ..."""
        return max(0, (max(1, int(width)) - 1).bit_length())

    @staticmethod
    def read_bucket(read_frac: float) -> int:
        """Quartile bucket 0..4 of the pass's read share."""
        return int(round(4.0 * min(max(float(read_frac), 0.0), 1.0)))

    def key(self, structure: str, tier: str, width: int,
            read_frac: float) -> tuple:
        return (structure, tier, self.width_bucket(width),
                self.read_bucket(read_frac))

    def observe(self, key: tuple, seconds: float, n_ops: int = 1) -> None:
        """Fold one measured pass (``seconds`` over ``n_ops`` ops) into
        the tier's EWMA.  Per-op normalization makes samples from
        different widths inside one bucket comparable."""
        per_op = max(0.0, float(seconds)) / max(1, int(n_ops))
        old = self._ewma.get(key)
        self._ewma[key] = per_op if old is None else (
            (1.0 - self.alpha) * old + self.alpha * per_op)
        self._n[key] = self._n.get(key, 0) + 1

    def cost(self, key: tuple) -> Optional[float]:
        return self._ewma.get(key)

    def samples(self, key: tuple) -> int:
        return self._n.get(key, 0)


class TierRouter:
    """Per-pass tier decision over a shared :class:`CostModel`.

    The decision rule per (width-bucket, read-bucket) context:

    * **cold start** — while any tier has fewer than ``explore_min``
      samples in this context, pick the least-sampled such tier: every
      tier is measured before any is trusted (exploration before
      exploitation).
    * **exploit** — pick the tier with the lowest EWMA per-op cost, with
      **hysteresis**: an incumbent is only displaced when the challenger
      is at least ``hysteresis`` (default 25%) cheaper, so a single
      noisy sample (already damped by the EWMA) cannot flap the route.
    * **re-exploration** (optional, ``explore_every=N``) — every Nth
      decision in a context samples a non-incumbent tier round-robin so
      a regime shift in a beaten tier is eventually re-measured.  Off by
      default: distinct workload regimes land in distinct (width, read)
      contexts and get their own cold start, and the incumbent's EWMA
      stays live — degradation past the frozen challenger cost still
      switches.

    ``force`` pins every decision to one tier (the ``--tier`` serving
    override / the static bench rows).  ``tier_decisions`` counts the
    decisions per tier — benches and tests assert convergence on it.
    The ``clock`` is injectable so tests drive the model with fake
    latencies deterministically.

    Graceful degradation (DESIGN.md §15): a
    :class:`~repro_torch.core.faults.CircuitBreaker` attached to a tier vetoes
    it while open — even over ``force`` — and the decision falls back to
    the first non-vetoed tier (host first, it has no dispatch to fail).
    Half-open probes flow back automatically once the cooldown elapses.
    """

    def __init__(self, structure: str, tiers: Sequence[str] = ALL_TIERS,
                 *, model: Optional[CostModel] = None,
                 force: Optional[str] = None, hysteresis: float = 0.25,
                 explore_min: int = 2, explore_every: int = 0,
                 clock: Callable[[], float] = time.perf_counter):
        if not tiers:
            raise ValueError("need at least one tier")
        if force is not None and force not in tiers:
            raise ValueError(f"forced tier {force!r} not in {tiers}")
        if not 0.0 <= hysteresis < 1.0:
            raise ValueError("hysteresis must be in [0, 1)")
        self.structure = structure
        self.tiers = tuple(tiers)
        self.model = model or CostModel()
        self.force = force
        self.hysteresis = float(hysteresis)
        self.explore_min = max(1, int(explore_min))
        self.explore_every = max(0, int(explore_every))
        self.clock = clock
        self.tier_decisions: Dict[str, int] = {t: 0 for t in self.tiers}
        self._incumbent: Dict[tuple, str] = {}
        self._n_choices: Dict[tuple, int] = {}
        self._explore_rr: Dict[tuple, int] = {}
        # hot-path caches: the decision runs once per combining pass, in
        # series with the pass itself — µs here are throughput on the
        # host tier.  _ctx_keys memoizes the model keys per context;
        # _warm marks contexts whose cold start completed (sample counts
        # only grow, so warmth never needs invalidation).
        self._ctx_keys: Dict[tuple, Dict[str, tuple]] = {}
        self._warm: set = set()
        self._breakers: Dict[str, CircuitBreaker] = {}

    # -- graceful degradation (DESIGN.md §15) ------------------------------
    def attach_breaker(self, tier: str, breaker: CircuitBreaker) -> None:
        """Let ``breaker`` veto ``tier`` while it is open."""
        if tier not in self.tiers:
            raise ValueError(f"unknown tier {tier!r} (have {self.tiers})")
        self._breakers[tier] = breaker

    def breaker_state(self) -> Dict[str, str]:
        return {t: b.state for t, b in self._breakers.items()}

    def _degrade(self, tier: str) -> str:
        """Swap a breaker-vetoed tier for the first allowed fallback,
        preferring the host tier (it has no device dispatch to fail)."""
        b = self._breakers.get(tier)
        if b is None or b.allows():
            return tier
        order = [t for t in self.tiers if t == TIER_HOST]
        order += [t for t in self.tiers if t != TIER_HOST and t != tier]
        for alt in order:
            ab = self._breakers.get(alt)
            if ab is None or ab.allows():
                return alt
        return tier   # everything vetoed: fail through to the original

    # -- decision ----------------------------------------------------------
    def _ctx(self, width: int, read_frac: float) -> tuple:
        return (self.model.width_bucket(width),
                self.model.read_bucket(read_frac))

    def _key(self, tier: str, width: int, read_frac: float) -> tuple:
        return self.model.key(self.structure, tier, width, read_frac)

    def choose(self, width: int, read_frac: float = 0.0) -> str:
        """Pick the execution tier for one collected batch."""
        if self.force is not None:
            tier = self.force
        else:
            tier = self._choose_auto(width, read_frac)
        if self._breakers:
            tier = self._degrade(tier)
        self.tier_decisions[tier] += 1
        return tier

    def _choose_auto(self, width: int, read_frac: float) -> str:
        model, ctx = self.model, self._ctx(width, read_frac)
        keys = self._ctx_keys.get(ctx)
        if keys is None:
            keys = {t: self._key(t, width, read_frac) for t in self.tiers}
            self._ctx_keys[ctx] = keys
        n = self._n_choices.get(ctx, 0)
        self._n_choices[ctx] = n + 1
        if ctx not in self._warm:
            # cold start: least-sampled under-explored tier first; tier
            # order breaks ties deterministically (strict < keeps the
            # earliest tier on equal sample counts)
            samples = model._n
            cold_t, cold_s = None, self.explore_min
            for t in self.tiers:
                s = samples.get(keys[t], 0)
                if s < cold_s:
                    cold_t, cold_s = t, s
            if cold_t is not None:
                return cold_t
            self._warm.add(ctx)
        incumbent = self._incumbent.get(ctx)
        if (self.explore_every and incumbent is not None
                and len(self.tiers) > 1
                and (n + 1) % self.explore_every == 0):
            # scheduled re-exploration: round-robin over the beaten tiers
            # WITHOUT dethroning the incumbent
            others = [t for t in self.tiers if t != incumbent]
            i = self._explore_rr.get(ctx, 0)
            self._explore_rr[ctx] = i + 1
            return others[i % len(others)]
        ewma = model._ewma
        best, best_c = None, math.inf
        for t in self.tiers:        # first-tier wins ties, as before
            c = ewma.get(keys[t])
            if c is not None and c < best_c:
                best, best_c = t, c
        if best is None:
            best = self.tiers[0]    # no samples at all (observe-free use)
        elif incumbent is not None and best != incumbent:
            inc_c = ewma.get(keys[incumbent])
            inc_c = math.inf if inc_c is None else inc_c
            if best_c >= (1.0 - self.hysteresis) * inc_c:
                best = incumbent      # inside the hysteresis band
        self._incumbent[ctx] = best
        return best

    # -- measurement -------------------------------------------------------
    def observe(self, tier: str, width: int, read_frac: float,
                seconds: float, n_ops: Optional[int] = None) -> None:
        """Feed one measured pass back into the cost model."""
        self.model.observe(self._key(tier, width, read_frac), seconds,
                           n_ops if n_ops is not None else width)

    @contextmanager
    def timed(self, tier: str, width: int, read_frac: float = 0.0,
              n_ops: Optional[int] = None):
        """Context manager measuring a pass with the injected clock."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.observe(tier, width, read_frac, self.clock() - t0, n_ops)


def track_pq_batch(track: dict, res: List, ne: int,
                   inserts: List[float]) -> None:
    """Update a ``{"n_live", "min_lb"}`` mirror after one applied batch.

    The single source of the bound-maintenance rule shared by the
    combiner engines (``pc_priority_queue`` and ``AsyncRoundsPQ``) — the
    elimination precondition ``min_lb ≤ true min`` lives or dies here.
    After a batch: remaining = (old \\ extracted) ∪ inserts, so its min
    is ≥ min(max(extracted), min(inserts)) — and just min(inserts) when
    an extract came back ``None`` (the old multiset was exhausted).
    ``inserts`` MUST already be device-quantized keys (``host_key``):
    the device stores f32 — feeding a raw f64 here can place ``min_lb``
    above the stored key and break the elimination precondition.
    """
    k = sum(1 for v in res if v is not None)
    track["n_live"] += len(inserts) - k
    ins_min = min(inserts) if inserts else math.inf
    if k < ne:                           # queue emptied mid-batch
        track["min_lb"] = ins_min
    elif ne > 0:
        track["min_lb"] = min(max(v for v in res if v is not None),
                              ins_min)
    else:
        track["min_lb"] = min(track["min_lb"], ins_min)
