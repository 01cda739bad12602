"""Deterministic fault injection + the fault-tolerance primitives.

The paper's design concentrates all progress in three single points of
failure: the combiner thread, the publication list, and the one donated
device program per combining pass.  This module makes those failure
modes *testable* (a seedable ``FaultPlan`` that kills the combiner at a
chosen pass, fails device dispatches with rate p, injects latency
spikes, and drops publication records) and *survivable*:

  * ``DispatchGuard`` — transactional device dispatch: snapshot shard
    state before a risky pass, restore bit-identically on failure, and
    retry with capped exponential backoff (DESIGN.md §15).
  * ``CircuitBreaker`` — closed/open/half-open with cooldown, fed by
    dispatch failure observations; ``TierRouter`` consults it so
    repeated device faults degrade to the host tier and probe back.
  * ``FaultCounters`` — faults_injected/retries/takeovers/restores
    counters surfaced through the scheduler and ``launch/serve.py``.

Everything is deterministic given the plan seed: two runs with the same
plan and the same thread interleaving inject the same faults, which is
what lets the differential fuzz suites compare against a sequential
oracle (EXPERIMENTS §Robustness).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Base class for all harness-injected failures."""


class InjectedDispatchError(InjectedFault):
    """A device dispatch the plan decided to fail."""


class InjectedCombinerKill(InjectedFault):
    """The combiner thread the plan decided to kill mid-protocol."""


class CombinerLeaseExpired(RuntimeError):
    """A bounded wait outlived the combiner lease with no takeover
    possible (the caller is not blocked on the global lock)."""


class FaultCounters:
    """Thread-safe counters for injected faults and recovery actions."""

    _FIELDS = ("combiner_kills", "dispatch_failures", "latency_spikes",
               "record_drops", "retries", "takeovers", "restores")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}

    @property
    def faults_injected(self) -> int:
        with self._lock:
            return (self.combiner_kills + self.dispatch_failures
                    + self.latency_spikes + self.record_drops)


class FaultPlan:
    """Seedable, deterministic fault schedule.

    All decision points draw from one ``numpy`` generator behind a lock,
    so a given (seed, sequence-of-probe-calls) pair always injects the
    same faults.  A plan is shared across the combiner, the scheduler,
    and the device structures of one stack; ``counters`` aggregates what
    actually fired.

    Parameters
    ----------
    kill_combiner_at_pass:
        1-based combining-pass index at which the *first* combiner to
        reach it dies (once per plan).  ``None`` disables.
    dispatch_fail_rate:
        probability each device dispatch raises
        ``InjectedDispatchError`` (post-dispatch, so the guard's restore
        path is genuinely exercised).
    max_dispatch_failures:
        cap on total injected dispatch failures (``None`` = unlimited).
        The standard plan caps them so a run always terminates even at
        high rates.
    latency_spike_passes:
        collection of 1-based pass indices at which the combiner sleeps
        ``latency_spike_s`` before combining — long enough to expire a
        short lease and exercise takeover.
    drop_record_rate:
        probability a publication-record insert is "dropped" (the client
        must re-publish; exercises the re-publication path).
    """

    def __init__(self, seed: int = 0, *,
                 kill_combiner_at_pass: Optional[int] = None,
                 dispatch_fail_rate: float = 0.0,
                 max_dispatch_failures: Optional[int] = None,
                 latency_spike_passes: tuple = (),
                 latency_spike_s: float = 0.0,
                 drop_record_rate: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.seed = seed
        self.kill_combiner_at_pass = kill_combiner_at_pass
        self.dispatch_fail_rate = float(dispatch_fail_rate)
        self.max_dispatch_failures = max_dispatch_failures
        self.latency_spike_passes = frozenset(latency_spike_passes)
        self.latency_spike_s = float(latency_spike_s)
        self.drop_record_rate = float(drop_record_rate)
        self._sleep = sleep
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._killed = False
        self._spiked = set()
        self.counters = FaultCounters()

    @classmethod
    def standard(cls, seed: int = 0, **overrides) -> "FaultPlan":
        """The reference fault plan: combiner killed at pass 3, 10%
        dispatch failure rate (capped so runs terminate), one latency
        spike at pass 5."""
        kw = dict(kill_combiner_at_pass=3, dispatch_fail_rate=0.10,
                  max_dispatch_failures=64, latency_spike_passes=(5,),
                  latency_spike_s=0.05)
        kw.update(overrides)
        return cls(seed, **kw)

    # -- probe points -------------------------------------------------
    def on_combiner_pass(self, pass_no: int) -> None:
        """Called by a combiner at the top of pass ``pass_no`` (1-based),
        before it reads any requests.  May sleep (latency spike) or
        raise ``InjectedCombinerKill`` (at most once per plan)."""
        spike = False
        kill = False
        with self._lock:
            if (pass_no in self.latency_spike_passes
                    and pass_no not in self._spiked):
                self._spiked.add(pass_no)
                spike = True
            if (self.kill_combiner_at_pass is not None
                    and pass_no >= self.kill_combiner_at_pass
                    and not self._killed):
                self._killed = True
                kill = True
        if spike:
            self.counters.bump("latency_spikes")
            if self.latency_spike_s > 0:
                self._sleep(self.latency_spike_s)
        if kill:
            self.counters.bump("combiner_kills")
            raise InjectedCombinerKill(
                f"fault plan killed combiner at pass {pass_no}")

    def maybe_fail_dispatch(self, site: str = "") -> None:
        """Called after a device dispatch returns; raises
        ``InjectedDispatchError`` with probability
        ``dispatch_fail_rate`` (until the cap is hit)."""
        if self.dispatch_fail_rate <= 0.0:
            return
        with self._lock:
            cap = self.max_dispatch_failures
            if cap is not None and self.counters.dispatch_failures >= cap:
                return
            fail = self._rng.random() < self.dispatch_fail_rate
        if fail:
            self.counters.bump("dispatch_failures")
            raise InjectedDispatchError(
                f"fault plan failed dispatch at {site or 'device'}")

    def maybe_drop_record(self) -> bool:
        """True if this publication-record insert should be dropped
        (client republishes)."""
        if self.drop_record_rate <= 0.0:
            return False
        with self._lock:
            drop = self._rng.random() < self.drop_record_rate
        if drop:
            self.counters.bump("record_drops")
        return drop


class CircuitBreaker:
    """Closed → open → half-open breaker over one routing tier.

    ``failure_threshold`` consecutive failures open the breaker; after
    ``cooldown_s`` one probe is let through (half-open).  A probe
    success closes the breaker, a probe failure re-opens it and restarts
    the cooldown.  The clock is injectable for deterministic tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        # caller holds self._lock
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = self.HALF_OPEN

    def allows(self) -> bool:
        """May traffic use this tier right now?  In half-open state only
        one caller at a time gets True (the probe)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN:
                # hand out exactly one probe per half-open window
                self._state = self.OPEN
                self._opened_at = self._clock()  # re-arm if probe dies
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._maybe_half_open()
            if (self._state != self.OPEN
                    and self._failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()


class DispatchGuard:
    """Transactional wrapper for the donated device-dispatch paths.

    ``run(thunk, snapshot, restore)`` takes a fresh snapshot before each
    attempt, runs the thunk (which performs the real dispatch, mutates
    host mirrors, and then asks the plan whether this dispatch "failed"),
    and on failure restores the snapshot bit-identically and retries
    with capped exponential backoff.  The snapshot copies are never
    donated, so restore works even though the pre-dispatch state buffers
    were consumed by the failed pass (DESIGN.md §15).

    A shared ``CircuitBreaker`` (optional) observes every outcome so the
    router can degrade to the host tier under repeated faults.
    """

    def __init__(self, plan: Optional[FaultPlan] = None, *,
                 breaker: Optional[CircuitBreaker] = None,
                 max_retries: int = 8, backoff_base_s: float = 1e-3,
                 backoff_cap_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep):
        self.plan = plan
        self.breaker = breaker
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._sleep = sleep
        self.counters = plan.counters if plan is not None else FaultCounters()

    def run(self, thunk: Callable[[], object], snapshot: Callable[[], object],
            restore: Callable[[object], None], *, site: str = ""):
        """Run ``thunk`` transactionally; returns its value.

        ``snapshot()`` must capture everything ``thunk`` mutates (device
        state tree + host mirrors); ``restore(snap)`` must rewind it
        bit-identically.  Pre-dispatch validation errors (``ValueError``
        from the occupancy guards) are *not* retried — they restore and
        re-raise immediately, because retrying a refused batch can never
        succeed.
        """
        attempt = 0
        while True:
            snap = snapshot()
            try:
                out = thunk()
                if self.plan is not None:
                    self.plan.maybe_fail_dispatch(site)
            except ValueError:
                # deterministic refusal (capacity/occupancy guard):
                # rewind any partial mirror mutation and hand the
                # refusal straight back — a retry would refuse again
                restore(snap)
                self.counters.bump("restores")
                raise
            except Exception:
                restore(snap)
                self.counters.bump("restores")
                if self.breaker is not None:
                    self.breaker.record_failure()
                attempt += 1
                if attempt > self.max_retries:
                    raise
                self.counters.bump("retries")
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** (attempt - 1)))
                if delay > 0:
                    self._sleep(delay)
                continue
            if self.breaker is not None:
                self.breaker.record_success()
            return out


def make_guard(fault_plan: Optional[FaultPlan] = None,
               guard=None, *, breaker: Optional[CircuitBreaker] = None
               ) -> Optional[DispatchGuard]:
    """Resolve the ``(fault_plan=, guard=)`` ctor-arg convention shared
    by the device structures: ``guard`` may be a ready
    :class:`DispatchGuard` (shared breaker), ``True`` (guard with no
    plan — the fault-free overhead row), ``False`` (never guard), or
    ``None`` (guard exactly when a fault plan is present)."""
    if isinstance(guard, DispatchGuard):
        return guard
    if guard is None:
        guard = fault_plan is not None
    if not guard:
        return None
    return DispatchGuard(fault_plan, breaker=breaker)
