"""The port's serving scheduler (``repro_torch.serving``) on the CPU.

Two parts:

- The reference's scheduler tests, ported to the port's ``PCScheduler``
  (``tests/test_substrate.py``'s serving-scheduler and shutdown tests,
  ``tests/test_faults.py``'s supervisor and close tests,
  ``tests/test_rounds.py``'s adaptive-rounds test and
  ``tests/test_elimination.py``'s combiner elimination tests, here also
  as scheduler passes).  Each waits on a future with a timeout, so a
  hang fails instead of stalling the suite.
- A differential: one scheduler from each package, their combiners idle
  (``pipeline=False``, ``supervise=False``, nothing submitted), fed the
  same seeded stream of published batches through ``_order`` — equal
  deadlines, ±inf, 1e39, subnormals and -0.0 among them — in every
  ordering tier, ``auto`` under one fake clock handed to both routers.
  After every pass the chosen epochs, the counters, the key table, the
  staging pool and the deadline PQ's contents must be equal.
"""
import itertools
import threading
import time
from collections import Counter
from concurrent.futures import Future

import numpy as np
import pytest

from repro.core.combining import TierRouter as JTierRouter
from repro.serving import scheduler as jsched
from repro_torch.core import batched_pq as tbpq
from repro_torch.core import pc_pq as tpc_pq
from repro_torch.core import sharded_pq as tspq
from repro_torch.core.combining import (ALL_TIERS, Request, Status,
                                        TierRouter)
from repro_torch.core.faults import FaultPlan
from repro_torch.serving import PCScheduler, SerialScheduler
from repro_torch.serving.scheduler import BatchRequest, _Entry

WAIT = 30       # seconds any one future may take before the test fails


def _pcs(step_fn, **kw):
    return PCScheduler(step_fn, device="cpu", **kw)


def _submit(sch, x, deadline=0.0):
    """Blocking submit with a timeout (``submit`` itself waits forever)."""
    return sch.submit_async(x, deadline=deadline).result(timeout=WAIT)


# ---------------------------------------------------------------------------
# serving scheduler (tests/test_substrate.py)
# ---------------------------------------------------------------------------
def test_pc_scheduler_combines_and_is_correct():
    calls = []

    def step_fn(rows):
        calls.append(len(rows))
        time.sleep(0.001)
        return [r * 10 for r in rows]

    sch = _pcs(step_fn, max_batch=8)
    outs = {}

    def sess(tid):
        outs[tid] = [_submit(sch, tid * 100 + i, deadline=i)
                     for i in range(15)]

    ts = [threading.Thread(target=sess, args=(t,)) for t in range(5)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    sch.close()
    for tid, res in outs.items():
        assert res == [(tid * 100 + i) * 10 for i in range(15)]
    assert len(outs) == 5
    assert max(calls) > 1                  # combining actually happened
    assert sum(calls) == 75


def test_pc_scheduler_respects_max_batch():
    def step_fn(rows):
        assert len(rows) <= 4
        return rows

    sch = _pcs(step_fn, max_batch=4)

    def sess(tid):
        for i in range(10):
            _submit(sch, i)

    ts = [threading.Thread(target=sess, args=(t,)) for t in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    sch.close()
    assert all(b <= 4 for b in sch.batches)
    assert sum(sch.batches) == 80


def test_pq_ordering_prefers_earlier_deadlines():
    """When more requests are pending than fit, the PQ picks the smallest
    deadlines first."""
    order = []
    gate = threading.Event()

    def step_fn(rows):
        order.extend(rows)
        time.sleep(0.005)
        return rows

    sch = _pcs(step_fn, max_batch=2, use_pq=True)

    def sess(tid):
        gate.wait()
        _submit(sch, tid, deadline=float(tid))

    ts = [threading.Thread(target=sess, args=(t,)) for t in range(6)]
    [t.start() for t in ts]
    gate.set()
    [t.join() for t in ts]
    sch.close()
    assert sorted(order) == list(range(6))


def test_submit_async_returns_futures_and_combines():
    """submit_async is non-blocking, returns futures; flooding the
    scheduler with concurrent async submissions yields mean_batch > 1."""
    def step_fn(rows):
        time.sleep(0.002)              # device step in flight
        return [r * 10 for r in rows]

    sch = _pcs(step_fn, max_batch=8)
    gate = threading.Event()
    futs = {}

    def sess(tid):
        gate.wait()
        futs[tid] = [sch.submit_async(tid * 100 + i, deadline=float(i))
                     for i in range(10)]

    ts = [threading.Thread(target=sess, args=(t,)) for t in range(4)]
    [t.start() for t in ts]
    gate.set()
    [t.join() for t in ts]
    for tid, fs in futs.items():
        assert all(isinstance(f, Future) for f in fs)
        assert [f.result(timeout=WAIT) for f in fs] == [
            (tid * 100 + i) * 10 for i in range(10)]
    assert sum(sch.batches) == 40
    assert sch.mean_batch > 1           # combining under concurrent load
    sch.close()


def test_async_scheduler_drains_on_close():
    sch = _pcs(lambda rows: [r + 1 for r in rows], max_batch=4)
    fs = [sch.submit_async(i) for i in range(13)]
    sch.close()                         # must serve everything first
    assert [f.result(timeout=5) for f in fs] == [i + 1 for i in range(13)]
    with pytest.raises(RuntimeError):
        sch.submit_async(0)


def _raises(rows):
    raise ValueError("step failed")


@pytest.mark.parametrize("step_fn, exc, match", [
    (_raises, ValueError, "step failed"),                    # step errors
    (lambda rows: rows[:-1], RuntimeError,                   # short return
     "0 outputs for a batch of 1"),
], ids=["step-error", "short-return"])
def test_step_failures_fail_the_batch(step_fn, exc, match):
    """A failing step_fn — one that raises, or one that returns fewer
    outputs than requests — fails the batch's futures instead of hanging
    them."""
    sch = _pcs(step_fn, max_batch=4, use_pq=False)
    f = sch.submit_async(7)
    with pytest.raises(exc, match=match):
        f.result(timeout=10)
    sch.close()


def test_persistent_pq_table_no_reinsert_churn():
    """Unchosen requests stay in the device PQ across passes: total PQ
    insert traffic equals the number of requests, not O(pending·passes)."""
    inserted = []

    sch = _pcs(lambda rows: (time.sleep(0.002), rows)[1], max_batch=2)
    orig_apply = sch._pq.apply
    orig_rounds = sch._pq.apply_rounds_async

    def counting_apply(extracts, inserts):
        inserted.extend(inserts)
        return orig_apply(extracts, inserts)

    def counting_rounds(rounds):
        for _ne, ins in rounds:
            inserted.extend(ins)
        return orig_rounds(rounds)

    sch._pq.apply = counting_apply
    sch._pq.apply_rounds_async = counting_rounds
    gate = threading.Event()

    def sess(tid):
        gate.wait()
        _submit(sch, tid, deadline=float(tid))

    ts = [threading.Thread(target=sess, args=(t,)) for t in range(8)]
    [t.start() for t in ts]
    gate.set()
    [t.join() for t in ts]
    sch.close()
    # each key is published at most once (never re-inserted on later
    # passes); single-request passes may bypass the device PQ entirely
    assert len(inserted) <= 8
    assert len(inserted) == len(set(inserted))


def test_extreme_deadlines_round_trip_through_device_pq():
    """Subnormal deadlines (flushed to 0 on device) and ±inf deadlines
    (clamped to the finite f32 range) must still resolve to their
    requests instead of killing the combiner with a table miss."""
    sch = _pcs(lambda rows: [r * 2 for r in rows], max_batch=4)
    deadlines = [1e-39, 0.0, float("inf"), 5.0, float("-inf")]
    futs = [sch.submit_async(i, deadline=d)
            for i, d in enumerate(deadlines)]
    assert [f.result(timeout=10) for f in futs] == [0, 2, 4, 6, 8]
    sch.close()


def test_cancelled_future_does_not_poison_batch():
    """Cancelling one request must not steal the results of the others
    batched with it."""
    release = threading.Event()

    def step_fn(rows):
        release.wait(10)
        return [r * 10 for r in rows]

    sch = _pcs(step_fn, max_batch=4, use_pq=False, pipeline=False)
    f1 = sch.submit_async(1)
    f2 = sch.submit_async(2)
    f3 = sch.submit_async(3)
    assert f2.cancel() or f2.done()     # cancel while pending/queued
    release.set()
    assert f1.result(timeout=10) == 10
    assert f3.result(timeout=10) == 30  # unaffected by f2's cancellation
    sch.close()


def test_nan_deadline_rejected_at_submit():
    sch = _pcs(lambda rows: rows, max_batch=4)
    with pytest.raises(ValueError, match="NaN"):
        sch.submit_async(1, deadline=float("nan"))
    assert _submit(sch, 5, deadline=0.0) == 5     # scheduler unharmed
    sch.close()


def test_ordering_failure_fails_futures_not_silence():
    """An exception on the ordering path must surface on the futures and
    leave the scheduler alive for later requests."""
    started = threading.Event()

    def slow(rows):
        started.set()
        time.sleep(0.15)
        return rows

    sch = _pcs(slow, max_batch=4, pipeline=False, rounds_cap=1)

    def boom(rounds):
        raise RuntimeError("device fell over")

    orig_pq = sch._pq
    f0 = sch.submit_async(0, deadline=0.0)   # single → eliminated, no PQ
    assert started.wait(10)
    sch._pq.apply_rounds_async = boom
    # six requests accumulate while the inline step sleeps → the next
    # pass overflows the elimination budget (rounds_cap·max_batch = 4)
    # and must publish the leftovers through the (broken) device PQ
    futs = [sch.submit_async(i, deadline=float(i)) for i in range(1, 7)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device fell over"):
            f.result(timeout=10)
    assert f0.result(timeout=10) == 0
    assert sch._pq is not orig_pq          # PQ rebuilt after the abort
    assert sch._pq.device == orig_pq.device
    assert _submit(sch, 21, deadline=0.0) == 21   # still serving
    sch.close()


def test_serial_scheduler_baseline():
    sch = SerialScheduler(lambda rows: [r + 1 for r in rows])
    assert sch.submit(41) == 42
    assert all(b == 1 for b in sch.batches)


def test_close_races_late_submitter_no_hang():
    """A submit racing close() either raises RuntimeError immediately or
    returns a future that RESOLVES (served or failed) — no caller may
    hang on a dead combiner loop, and every post-close submit raises."""
    for trial in range(3):
        sch = _pcs(lambda rows: [r + 1 for r in rows], max_batch=4)
        accepted, rejected = [], []
        stop = threading.Event()

        def late_submitter():
            i = 0
            while not stop.is_set() and i < 500:
                try:
                    accepted.append((i, sch.submit_async(i)))
                except RuntimeError:
                    rejected.append(i)
                i += 1

        t = threading.Thread(target=late_submitter)
        t.start()
        time.sleep(0.005 * (trial + 1))
        sch.close()
        stop.set()
        t.join(10)
        assert not t.is_alive()
        for i, f in accepted:
            try:
                assert f.result(timeout=5) == i + 1   # served on drain
            except RuntimeError:
                pass            # failed with the shutdown exception: fine
        with pytest.raises(RuntimeError):
            sch.submit_async(0)
        with pytest.raises(RuntimeError):
            sch.submit(0)


@pytest.mark.parametrize("dead_loop", [False, True],
                         ids=["after-close", "dead-combiner"])
def test_submit_onto_stopped_scheduler_raises(dead_loop):
    """After close, submit raises; and if the combiner thread is gone
    without close (a dead loop), submit must raise too — enqueueing
    would strand the future forever."""
    sch = _pcs(lambda rows: rows, max_batch=4, n_shards=2)
    sch.close()
    if dead_loop:
        sch._closed = False      # simulate a dead loop without close()
    with pytest.raises(RuntimeError, match="closed"):
        sch.submit_async(1)


def test_close_fails_unserved_requests_instead_of_hanging():
    """Requests the workers can no longer serve are drained WITH an
    exception at close() — the caller gets RuntimeError, not a hang."""
    sch = _pcs(lambda rows: rows, max_batch=4, use_pq=False)
    sch.close()
    # a request stranded after the workers stopped (dead-loop scenario)
    ent = _Entry(BatchRequest(inputs=1), Future())
    sch._pending.append(ent)
    sch.close()                  # second close sweeps, not early-returns
    with pytest.raises(RuntimeError, match="closed before"):
        ent.future.result(timeout=5)


def test_pq_overflow_refusal_keeps_resident_requests():
    """A deadline-PQ occupancy refusal fails ONLY the flood's futures —
    resident requests keep their place (device PQ, table and lazy
    min-heap untouched thanks to the PQ-side atomic guard) and are
    served by later passes."""
    def slow_step(rows):
        time.sleep(0.1)
        return [r * 2 for r in rows]

    sch = _pcs(slow_step, max_batch=2, rounds_cap=1,
               pq_capacity=8, n_shards=1, pipeline=False)
    f0 = sch.submit_async(0, deadline=0.0)
    time.sleep(0.02)             # let pass 1 start its slow step
    stage1 = [sch.submit_async(i, deadline=float(i))
              for i in range(1, 7)]      # 2 eliminated + 4 PQ residents
    time.sleep(0.12)             # pass 2 publishes the residents
    flood = [sch.submit_async(100 + i, deadline=100.0 + i)
             for i in range(12)]         # overflows the 8-slot shard
    failed = 0
    for i, f in enumerate(flood):
        try:
            # a flood entry that slipped into an earlier (legal) pass is
            # served normally; the rest fail with the refusal
            assert f.result(timeout=10) == (100 + i) * 2
        except ValueError as e:
            assert "capacity" in str(e)
            failed += 1
    assert failed > 0            # the refusal surfaced on flood futures
    assert f0.result(timeout=10) == 0
    for i, f in enumerate(stage1, start=1):
        assert f.result(timeout=10) == i * 2   # residents survived
    assert _submit(sch, 50, deadline=0.0) == 100  # still serving
    sch.close()
    assert sch._peek_resident() is None         # heap fully drained


@pytest.fixture
def one_rank_world():
    """The one-rank process group ``make_combining_mesh`` starts, torn
    down after the test so no group outlives it in the worker."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_placement_waits_for_the_placement_layer(one_rank_world):
    """``pq_placement`` on a one-rank mesh (DESIGN.md §18): the deadline
    PQ's shards live on the mesh and the scheduler orders the same
    published stream exactly as the stacked one, pass by pass; junk is
    refused."""
    from repro_torch.core.placement import MeshPlacement
    from repro_torch.launch.mesh import make_combining_mesh

    with pytest.raises(TypeError, match="not a placement"):
        _pcs(lambda rows: rows, pq_placement=object())
    kw = dict(max_batch=4, rounds_cap=2, n_shards=2, pq_capacity=64,
              tier="device", device="cpu")
    pl = MeshPlacement(make_combining_mesh(2, device="cpu"))
    stacked = _idle(PCScheduler, **kw)
    placed = _idle(PCScheduler, pq_placement=pl, **kw)
    try:
        assert placed._pq.placement is pl and pl.is_mesh
        epoch = 0
        for p, keys in enumerate(_stream(5) + [[] for _ in range(4)]):
            es = _entries(_Entry, BatchRequest, keys, epoch)
            ep = _entries(_Entry, BatchRequest, keys, epoch)
            epoch += len(keys)
            got_s = [[e.epoch for e in b] for b in stacked._order(es)]
            got_p = [[e.epoch for e in b] for b in placed._order(ep)]
            assert got_p == got_s, f"pass {p}: chosen epochs differ"
            assert _snapshot(placed) == _snapshot(stacked), f"pass {p}"
        assert placed.pq_dispatches > 0
    finally:
        stacked.close()
        placed.close()


def test_mesh_placed_pq_keeps_its_communicator_across_takeover(
        one_rank_world):
    """A combiner kill rebuilds the placed deadline PQ on the first
    queue's group (no communicator starts on the recovery path), every
    request is served once, and ``close`` destroys that group."""
    from repro_torch.core.placement import MeshPlacement
    from repro_torch.launch.mesh import make_combining_mesh

    pl = MeshPlacement(make_combining_mesh(2, device="cpu"))
    plan = FaultPlan(0, kill_combiner_at_pass=2)
    served = []

    def step(xs):
        served.extend(xs)
        return [x * 2 for x in xs]

    s = _pcs(step, max_batch=4, n_shards=2, fault_plan=plan,
             pq_placement=pl)
    comm = s._pq.comm
    first = s._pq
    futs = [s.submit_async(i, deadline=float(i % 5)) for i in range(24)]
    assert [f.result(timeout=WAIT) for f in futs] == [i * 2
                                                     for i in range(24)]
    assert s.takeovers >= 1 and s._pq is not first
    assert s._pq.comm is comm and comm.group is not None
    s.close()
    assert Counter(served) == Counter(range(24))
    assert comm.group is None


# ---------------------------------------------------------------------------
# supervisor recovery + close()/in-flight race (tests/test_faults.py)
# ---------------------------------------------------------------------------
def test_scheduler_supervisor_recovers_exactly_once():
    plan = FaultPlan(0, kill_combiner_at_pass=2)
    served = []

    def step(xs):
        served.extend(xs)
        return [x * 2 for x in xs]

    with _pcs(step, max_batch=4, n_shards=2, fault_plan=plan) as s:
        futs = [s.submit_async(i, deadline=float(i % 5))
                for i in range(24)]
        outs = [f.result(timeout=WAIT) for f in futs]
    assert outs == [i * 2 for i in range(24)]
    assert Counter(served) == Counter(range(24))   # zero lost, zero dup
    assert s.takeovers >= 1
    assert s.fault_counters()["combiner_kills"] == 1
    assert s._pq.device.type == "cpu"              # rebuilt on its device


def test_scheduler_guarded_pq_survives_dispatch_faults():
    plan = FaultPlan(1, dispatch_fail_rate=0.9, max_dispatch_failures=6)
    with _pcs(lambda xs: [x + 1 for x in xs], max_batch=4,
              n_shards=2, tier="device", fault_plan=plan) as s:
        futs = [s.submit_async(i, deadline=float((i * 7) % 5))
                for i in range(30)]
        outs = [f.result(timeout=60) for f in futs]
    assert outs == [i + 1 for i in range(30)]
    c = s.fault_counters()
    assert c["dispatch_failures"] >= 1 and c["restores"] >= 1
    assert "breaker_state" in c


def test_scheduler_close_waits_for_inflight_step():
    """close() while a slow device step is mid-flight must let the step
    finish and resolve its future with the RESULT — not sweep it into the
    doomed-futures RuntimeError."""
    release = threading.Event()
    entered = threading.Event()

    def slow_step(xs):
        entered.set()
        release.wait(timeout=10)
        return [x + 1 for x in xs]

    s = _pcs(slow_step, max_batch=8, n_shards=2)
    f = s.submit_async(41, deadline=0.0)
    assert entered.wait(timeout=10)
    closer = threading.Thread(target=s.close)
    closer.start()
    time.sleep(0.05)                   # close() is now waiting on workers
    release.set()
    closer.join(timeout=10)
    assert not closer.is_alive()
    assert f.result(timeout=1) == 42


# ---------------------------------------------------------------------------
# adaptive rounds (tests/test_rounds.py) and elimination
# (tests/test_elimination.py)
# ---------------------------------------------------------------------------
def test_scheduler_adaptive_rounds_and_elimination():
    """Backlog > max_batch: the scheduler serves it as up to rounds_cap
    urgency-ordered batches per ordering pass — host-eliminated requests
    cost zero PQ programs, the leftovers exactly one fused dispatch."""
    gate = threading.Event()
    started = threading.Event()

    def step(rows):
        started.set()
        gate.wait(10)
        return rows

    sch = _pcs(step, max_batch=2, rounds_cap=4, pipeline=False)
    f0 = sch.submit_async(0, deadline=0.0)
    assert started.wait(10)
    # 10 requests accumulate while the inline step blocks
    futs = [sch.submit_async(i, deadline=float(i)) for i in range(1, 11)]
    gate.set()
    assert [f.result(timeout=WAIT) for f in [f0] + futs] == list(range(11))
    sch.close()
    # pass 1 eliminated f0; pass 2 eliminated budget (8) of the 10 and
    # published the 2 leftovers (1 dispatch); pass 3 extracted them
    # (1 dispatch)
    assert sch.eliminated == 9
    assert sch.pq_dispatches == 2
    assert all(b <= 2 for b in sch.batches)
    assert sum(sch.batches) == 11


def _count_device_work(monkeypatch):
    """Count the deadline PQ's passes and blocking fetches."""
    passes, fetches = [], []
    orig_pass, orig_fetch = tspq._sharded_apply_batch, tbpq._host_fetch

    def counting_pass(*a, **kw):
        passes.append(1)
        return orig_pass(*a, **kw)

    def counting_fetch(tree):
        fetches.append(1)
        return orig_fetch(tree)

    monkeypatch.setattr(tspq, "_sharded_apply_batch", counting_pass)
    monkeypatch.setattr(tbpq, "_host_fetch", counting_fetch)
    return passes, fetches


def test_scheduler_eliminates_on_empty_queue(monkeypatch):
    """With nothing resident in the deadline PQ, every request is served
    by the elimination pre-pass: ZERO device work — no pass AND no
    blocking fetch."""
    passes, fetches = _count_device_work(monkeypatch)
    with _pcs(lambda rows: [r + 1 for r in rows], max_batch=4,
              n_shards=2) as sch:
        futs = [sch.submit_async(i, deadline=float(7 - i)) for i in range(8)]
        assert [f.result(timeout=WAIT) for f in futs] == list(range(1, 9))
    assert sch.eliminated == 8
    assert sch.pq_dispatches == 0
    assert passes == [] and fetches == []


def _idle(sched_cls, step=lambda rows: rows, **kw):
    """A scheduler whose combiner idles: nothing is submitted, the test
    thread calls ``_order`` itself."""
    return sched_cls(step, pipeline=False, supervise=False, **kw)


def _entries(entry_cls, request_cls, keys, first_epoch):
    return [entry_cls(request_cls(inputs=i, deadline=d), Future(),
                      epoch=first_epoch + i)
            for i, d in enumerate(keys)]


def test_scheduler_elimination_respects_queue_min():
    """With resident keys, only new keys that undercut (or tie) the
    smallest resident key eliminate; the rest are published, and the
    resident minimum is extracted before them."""
    sch = _idle(PCScheduler, max_batch=2, rounds_cap=1, n_shards=2,
                device="cpu")
    try:
        e = _entries(_Entry, BatchRequest, [5.0, 6.0, 7.0], 0)
        # budget 2: 5 and 6 eliminate, 7 is published (resident)
        assert sch._order(e) == [e[:2]]
        assert (sch.eliminated, sch.pq_dispatches, sch._queued) == (2, 1, 1)
        f = _entries(_Entry, BatchRequest, [3.0, 7.0, 8.0], 3)
        # 3 and the tie at 7 undercut the resident 7 — but the budget is
        # 2, so 8 is published and nothing is extracted this pass
        assert sch._order(f) == [f[:2]]
        assert sch.eliminated == 4
        assert sorted(sch._pq.values()) == [7.0, 8.0]
        # the residents drain in key order
        assert sch._order([]) == [[e[2], f[2]]]
        assert sch._queued == 0 and sch._peek_resident() is None
    finally:
        sch.close()


def _reqs(ops):
    return [Request(method=m, input=v, status=Status.PUSHED) for m, v in ops]


def test_pc_combiner_eliminates_on_empty_queue(monkeypatch):
    """Insert/extract pairs on an empty queue are served with ZERO device
    work — no dispatch AND no blocking sync."""
    passes, fetches = _count_device_work(monkeypatch)
    eng = tpc_pq.pc_priority_queue(
        tspq.ShardedBatchedPQ(256, c_max=8, n_shards=2, device="cpu"))
    reqs = _reqs([("insert", 5.0), ("extract_min", None),
                  ("insert", 3.0), ("extract_min", None)])
    eng.combiner_code(eng, reqs)
    assert [r.res for r in reqs if r.method == "extract_min"] == [3.0, 5.0]
    assert all(r.status == Status.FINISHED for r in reqs)
    assert eng.eliminated == 2
    assert passes == [] and fetches == []


def test_pc_combiner_elimination_respects_queue_min():
    """With resident keys, only inserts that provably undercut the queue
    minimum eliminate; everything else keeps the unfused batch order
    (extracts see the pre-batch multiset)."""
    pq = tspq.ShardedBatchedPQ(256, c_max=8, n_shards=2,
                               values=[10.0, 20.0], device="cpu")
    eng = tpc_pq.pc_priority_queue(pq)
    # pass 1: min bound unknown (-inf) → NO elimination; the extract
    # sees the pre-batch multiset (NOT the 0.5 inserted in-batch)
    reqs = _reqs([("insert", 0.5), ("extract_min", None)])
    eng.combiner_code(eng, reqs)
    assert reqs[1].res == 10.0
    assert eng.eliminated == 0
    # the answer taught the combiner min ≥ 0.5: an insert at 0.3 now
    # pairs host-side and the queue is untouched
    reqs2 = _reqs([("insert", 0.3), ("extract_min", None)])
    eng.combiner_code(eng, reqs2)
    assert reqs2[1].res == float(np.float32(0.3))
    assert eng.eliminated == 1
    np.testing.assert_allclose(pq.values(), [0.5, 20.0])


# ---------------------------------------------------------------------------
# differential: the port's _order against the reference's, pass by pass
# ---------------------------------------------------------------------------
SPECIAL = [0.0, -0.0, 1e-40, -1e-42, float("inf"), float("-inf"), 1e39,
           -1e39, 3.0, 3.0, 7.5]


def _stream(seed, n_passes=10, width=12):
    """Seeded published batches: ties, ±inf, 1e39, subnormals, -0.0."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(n_passes):
        k = int(rng.integers(0, width + 1)) if p else width
        out.append([SPECIAL[int(rng.integers(len(SPECIAL)))]
                    if rng.random() < 0.4 else
                    float(rng.integers(-4, 12)) for _ in range(k)])
    return out


def _fake_clock():
    """A deterministic clock: each reading advances by a seeded step, so
    both routers see the same pass costs."""
    steps = np.random.default_rng(11).uniform(1e-4, 1e-2, 4096)
    t = itertools.accumulate(steps)
    return lambda: float(next(t))


def _snapshot(sch):
    return {
        "eliminated": sch.eliminated, "pq_dispatches": sch.pq_dispatches,
        "pq_rounds": sch.pq_rounds, "queued": sch._queued,
        "staged": [e.epoch for e in sch._staged],
        "table": sorted((k, [e.epoch for e in b])
                        for k, b in sch._table.items()),
        "resident_min": sch._peek_resident(),
        "pq": [float(v) for v in sch._pq.values()],
        "decisions": dict(sch.tier_decisions),
    }


def _run_both(tier, stream, **kw):
    routers = {}
    if tier == "auto":
        routers = dict(j=JTierRouter("sched", ALL_TIERS, clock=_fake_clock()),
                       t=TierRouter("sched", ALL_TIERS, clock=_fake_clock()))
    js = _idle(jsched.PCScheduler, tier=tier, router=routers.get("j"), **kw)
    ts = _idle(PCScheduler, tier=tier, router=routers.get("t"),
               device="cpu", **kw)
    failed = []
    try:
        epoch = 0
        for p, keys in enumerate(stream):
            je = _entries(jsched._Entry, jsched.BatchRequest, keys, epoch)
            te = _entries(_Entry, BatchRequest, keys, epoch)
            epoch += len(keys)
            got_j = [[e.epoch for e in b] for b in js._order(je)]
            got_t = [[e.epoch for e in b] for b in ts._order(te)]
            assert got_t == got_j, f"pass {p}: chosen epochs differ"
            assert _snapshot(ts) == _snapshot(js), f"pass {p}"
            fj = [e.epoch for e in je if e.future.done()]
            ft = [e.epoch for e in te if e.future.done()]
            assert ft == fj, f"pass {p}: failed requests differ"
            for e in te:
                if e.future.done():
                    failed.append(type(e.future.exception()))
        return _snapshot(ts), failed
    finally:
        js.close()
        ts.close()


@pytest.mark.parametrize("tier", ["eliminate", "device", "host", "auto"])
def test_order_matches_the_reference_pass_by_pass(tier):
    kw = dict(max_batch=4, rounds_cap=2, n_shards=2, pq_capacity=64)
    stream = _stream(3) + [[] for _ in range(4)]      # then drain
    final, failed = _run_both(tier, stream, **kw)
    assert not failed
    assert sum(final["decisions"].values()) == len(stream)
    # the stream overflows the pass budget: the device PQ is used on
    # every tier that publishes, and the host tier stages
    assert (final["pq_dispatches"] > 0) == (tier != "host")
    assert final["eliminated"] > 0 or tier == "device"
    if tier != "auto":
        assert final["decisions"][tier] == len(stream)


def test_order_occupancy_refusal_matches_the_reference():
    """A deadline PQ of 3 live slots a shard: the second pass's publish
    would overflow it, so both packages fail exactly that pass's new
    requests and keep serving the resident one."""
    kw = dict(max_batch=2, rounds_cap=1, n_shards=1, pq_capacity=4)
    stream = [[4.0, 1.0, 2.0], [9.0, 5.0, 6.0, 7.0, 8.0], [], [0.5]]
    final, failed = _run_both("device", stream, **kw)
    assert failed == [ValueError] * 5
    assert final["queued"] == 0 and final["pq"] == []
