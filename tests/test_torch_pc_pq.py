"""The port's PQ front-ends against ``SequentialHeap``.

Deterministic single-thread streams through ``pc_priority_queue``,
``pc_sharded_priority_queue``, ``pc_adaptive_priority_queue`` and
``fc_priority_queue`` (each op is its own combining pass, so the answers
are the sequential heap's), ``AsyncRoundsPQ`` on prefix-determined
streams, and a small threaded run that must conserve the multiset.
"""
import threading

import numpy as np
import pytest

from repro_torch.core import pc_pq
from repro_torch.core.batched_pq import BatchedPriorityQueue
from repro_torch.core.seq_pq import SequentialHeap
from repro_torch.core.sharded_pq import ShardedBatchedPQ


def ops_stream(seed, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < 0.55:
            out.append(("insert", float(np.float32(rng.integers(0, 40)))))
        else:
            out.append(("extract_min", None))
    return out


def make_engine(name, init):
    if name == "pc":
        return pc_pq.pc_priority_queue(
            BatchedPriorityQueue(256, 4, values=init, device="cpu"))
    if name == "pc-noelim":
        return pc_pq.pc_priority_queue(
            BatchedPriorityQueue(256, 4, values=init, device="cpu"),
            eliminate=False)
    if name == "pc-sharded":
        return pc_pq.pc_sharded_priority_queue(128, 4, n_shards=2,
                                               values=init, device="cpu")
    if name == "pc-adaptive":
        return pc_pq.pc_adaptive_priority_queue(
            ShardedBatchedPQ(128, 4, n_shards=2, values=init, device="cpu"))
    assert name == "fc" and not init      # the FC heap starts empty
    return pc_pq.fc_priority_queue()


@pytest.mark.parametrize("name", ["pc", "pc-noelim", "pc-sharded",
                                  "pc-adaptive", "fc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_single_thread_stream_equals_sequential_heap(name, seed):
    init = [float(v) for v in np.random.default_rng(seed + 9).integers(
        0, 40, 12)] if name != "fc" else []
    engine = make_engine(name, init)
    oracle = SequentialHeap()
    for v in init:
        oracle.insert(v)
    for method, arg in ops_stream(seed):
        assert engine.execute(method, arg) == oracle.apply(method, arg)


def test_async_rounds_pq_answers_and_conserves():
    init = [float(v) for v in range(20)]
    with pc_pq.AsyncRoundsPQ(ShardedBatchedPQ(128, 4, n_shards=2,
                                              values=init, device="cpu"),
                             rounds_cap=3) as q:
        futs = [q.extract_async() for _ in range(7)]
        assert [f.result(timeout=60) for f in futs] == init[:7]
        for v in (100.0, 50.0, 75.0):
            q.insert(v)
        rest = [q.extract_async() for _ in range(16)]
        got = [f.result(timeout=60) for f in rest]
    assert q.dispatches >= 1 and q.rounds >= q.dispatches
    remaining = q.pq.values()
    assert sorted(init[7:] + [100.0, 50.0, 75.0]) == sorted(
        [g for g in got if g is not None] + remaining)


def test_threaded_run_conserves_the_multiset():
    init = [float(v) for v in range(0, 200, 3)]
    engine = pc_pq.pc_sharded_priority_queue(128, 8, n_shards=2,
                                             values=init, device="cpu")
    inserted, extracted = [[] for _ in range(3)], [[] for _ in range(3)]
    errors = []

    def client(tid):
        try:
            rng = np.random.default_rng(tid)
            for _ in range(25):
                if rng.random() < 0.5:
                    v = float(np.float32(rng.uniform(0, 300)))
                    engine.execute("insert", v)
                    inserted[tid].append(v)
                else:
                    extracted[tid].append(engine.execute("extract_min"))
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    ins = [v for lst in inserted for v in lst]
    ext = [v for lst in extracted for v in lst if v is not None]
    assert sorted(init + ins) == sorted(ext + engine.pq.values())
    assert engine.passes <= 75
