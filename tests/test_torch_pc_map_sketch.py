"""The port's map and sketch combining front-ends on the CPU.

``pc_sharded_map`` / ``pc_sharded_sketch`` under client threads (size and
total conservation, sorted shards, final contents equal to a replay of
every effective op); ``pc_megapass_map`` against its alternating twin and
the sequential map; the adaptive engines pinned to each tier against the
JAX reference's adaptive engines on the same streams, and crossing tiers
against the host oracle; ``fc_map`` / ``fc_sketch``.
"""
import sys
import threading

import numpy as np
import pytest

from repro.core.pc_map import pc_adaptive_map as j_adaptive_map
from repro.core.pc_sketch import pc_adaptive_sketch as j_adaptive_sketch
from repro.core.combining import TierRouter as JRouter
from repro_torch.core import batched_map as tbm
from repro_torch.core import batched_sketch as tbs
from repro_torch.core.combining import TIER_DEVICE, TIER_HOST, TierRouter
from repro_torch.core.pc_map import (fc_map, pc_adaptive_map,
                                     pc_megapass_map, pc_sharded_map)
from repro_torch.core.pc_sketch import (fc_sketch, pc_adaptive_sketch,
                                        pc_sharded_sketch)
from repro_torch.core.seq_map import SequentialSortedMap
from repro_torch.core.seq_sketch import SequentialSketch
from repro_torch.core.sharded_pq import route_hash_host, route_range_host

KR = (0.0, 100.0)


def _map_items(seed, n=60):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.uniform(0, 100, n).astype(np.float32))
    return [(float(k), float(v)) for k, v in
            zip(keys, rng.uniform(0, 10, keys.size).astype(np.float32))]


def _map_draw(r, known, read_pct=70):
    p = r.random() * 100
    if p < read_pct:
        q = int(r.integers(0, 4))
        if q == 0:
            return "lookup", float(known[r.integers(len(known))])
        if q == 1:
            return "kth_smallest", int(r.integers(1, 40))
        lo = float(np.float32(r.uniform(0, 90)))
        return ("range_count" if q == 2 else "range_sum"), (lo, lo + 10.0)
    q = int(r.integers(0, 3))
    if q == 0:
        return "insert", (float(np.float32(r.uniform(*KR))),
                          float(np.float32(r.uniform(0, 10))))
    if q == 1:
        return "assign", (float(known[r.integers(len(known))]),
                          float(np.float32(r.uniform(0, 10))))
    return "delete", float(known[r.integers(len(known))])


def _run_threads(engine, draw, n_threads=6, n_ops=40, seed=1):
    logs = [[] for _ in range(n_threads)]

    def client(tid):
        r = np.random.default_rng([seed, tid])
        for _ in range(n_ops):
            m, i = draw(r)
            logs[tid].append((m, i, engine.execute(m, i)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=client, args=(t,))
              for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    return logs


def _check_sorted(state, route):
    keys, size = state.keys.numpy(), state.size.numpy()
    for k in range(keys.shape[0]):
        body = keys[k, :size[k]]
        assert np.all(np.diff(body) > 0) and np.all(route(body) == k)
        assert np.all(np.isposinf(keys[k, size[k]:]))


def test_pc_sharded_map_threads_conserve_size_and_stay_sorted():
    items = _map_items(0)
    known = np.asarray([k for k, _ in items], np.float32)
    engine = pc_sharded_map(128, 4, n_shards=4, key_range=KR, items=items,
                            device="cpu")
    m = engine.ds
    logs = _run_threads(engine, lambda r: _map_draw(r, known))
    ins = sum(1 for log in logs for mt, _, res in log
              if mt == "insert" and res)
    dels = sum(1 for log in logs for mt, _, res in log
               if mt == "delete" and res)
    assert len(m) == len(items) + ins - dels
    _check_sorted(m.state, lambda b: route_range_host(b, 4, *KR))
    assert engine.passes > 0 and max(engine.combined_sizes) >= 1
    # every surviving key was initial or inserted, every initial key that
    # is gone was deleted
    final = dict(m.items())
    inserted = {i[0] for log in logs for mt, i, res in log
                if mt == "insert" and res}
    deleted = {i for log in logs for mt, i, res in log
               if mt == "delete" and res}
    initial = {k for k, _ in items}
    assert set(final) <= initial | inserted
    assert initial - set(final) <= deleted


def test_pc_sharded_sketch_threads_conserve_totals():
    rng = np.random.default_rng(2)
    keys = np.unique(rng.uniform(0, 100, 50).astype(np.float32))
    items = [(float(k), float(w)) for k, w in
             zip(keys, rng.integers(1, 10, keys.size))]
    engine = pc_sharded_sketch(256, 4, n_shards=4, items=items,
                               device="cpu")
    s = engine.ds

    def draw(r):
        if r.random() < 0.6:
            q = int(r.integers(0, 4))
            return (("count", float(keys[r.integers(len(keys))])),
                    ("total", None), ("distinct", None),
                    ("topk", int(r.integers(1, 8))))[q]
        key = float(keys[r.integers(len(keys))]) if r.random() < 0.7 \
            else float(np.float32(r.uniform(0, 100)))
        return "add", (key, float(int(r.integers(1, 10))))

    logs = _run_threads(engine, draw)
    adds = [(i, res) for log in logs for mt, i, res in log if mt == "add"]
    want = SequentialSketch(items + [i for i, _ in adds])
    assert s.counters() == want.items()
    assert s.distinct() == len(keys) + sum(res for _, res in adds)
    assert s.total() == want.total()
    _check_sorted(s.state, lambda b: route_hash_host(b, 4))


@pytest.mark.parametrize("use_megapass", [True, False])
def test_megapass_map_equals_alternating_twin_and_oracle(use_megapass):
    items = _map_items(3)
    known = np.asarray([k for k, _ in items], np.float32)
    rng = np.random.default_rng(4)
    ops = [_map_draw(rng, known, read_pct=50) for _ in range(150)]
    eng = pc_megapass_map(128, 4, n_shards=4, key_range=KR, items=items,
                          rounds_cap=4, use_megapass=use_megapass,
                          device="cpu")
    with eng:
        futs = [eng.submit(m, i) for m, i in ops]
        got = [f.result(timeout=120) for f in futs]
    # rounds are a serial schedule in submission order
    host = SequentialSortedMap(items)
    for (m, i), g in zip(ops, got):
        w = host.apply(m, i)
        assert tbm._result_ok(m, g, w) and (m == "range_sum" or g == w)
    assert eng.ds.items() == host.items()
    assert eng.megapass_rounds >= eng.megapass_dispatches > 0
    if not use_megapass:
        assert eng.megapass_rounds == eng.megapass_dispatches


def _map_stream(seed, n_batches=14):
    rng = np.random.default_rng(seed)
    ctx = {}
    return [(*tbm._gen_update(rng, int(rng.integers(1, 7)), ctx),
             *tbm._gen_read(rng, int(rng.integers(1, 5)), ctx))
            for _ in range(n_batches)]


@pytest.mark.parametrize("tier", [TIER_HOST, TIER_DEVICE])
def test_adaptive_map_pinned_tier_equals_reference(tier):
    items = _map_items(5)
    kw = dict(n_shards=4, key_range=KR, items=items)
    port = pc_adaptive_map(128, 4, device="cpu",
                           router=TierRouter("map", (TIER_HOST, TIER_DEVICE),
                                             force=tier), **kw).adaptive_ds
    ref = j_adaptive_map(128, 4, router=JRouter("map", ("host", "device"),
                                                force=tier),
                         **kw).adaptive_ds
    for ms, ins, qm, qi in _map_stream(6):
        assert port.update_batch(ms, ins) == ref.update_batch(ms, ins)
        for m, g, w in zip(qm, port.read_batch(qm, qi),
                           ref.read_batch(qm, qi)):
            assert tbm._result_ok(m, g, w) and (m == "range_sum" or g == w)
    served = port.host if tier == TIER_HOST else port.device
    assert served.items() == (ref.host if tier == TIER_HOST
                              else ref.device).items()


def test_adaptive_map_and_sketch_crossing_tiers_equal_host_oracle():
    items = _map_items(7)
    eng = pc_adaptive_map(128, 4, n_shards=4, key_range=KR, items=items,
                          device="cpu")
    eng.router.explore_every = 2
    host = SequentialSortedMap(items)
    for ms, ins, qm, qi in _map_stream(8, 20):
        for m, i in zip(ms + qm, ins + qi):
            g, w = eng.execute(m, i), host.apply(m, i)
            assert tbm._result_ok(m, g, w) and (m == "range_sum" or g == w)
    assert min(eng.tier_decisions.values()) > 0
    sk = pc_adaptive_sketch(256, 4, n_shards=2, device="cpu")
    sk.router.explore_every = 2
    oracle = SequentialSketch()
    rng = np.random.default_rng(9)
    ctx = {}
    for _ in range(20):
        for ms, ins in (tbs._gen_update(rng, 4, ctx),
                        tbs._gen_read(rng, 3, ctx)):
            for m, i in zip(ms, ins):
                assert sk.execute(m, i) == oracle.apply(m, i)
    assert min(sk.tier_decisions.values()) > 0


@pytest.mark.parametrize("tier", [TIER_HOST, TIER_DEVICE])
def test_adaptive_sketch_pinned_tier_equals_reference(tier):
    rng = np.random.default_rng(10)
    items = [(float(k), float(w)) for k, w in
             zip(rng.uniform(0, 100, 30).astype(np.float32),
                 rng.integers(1, 10, 30))]
    port = pc_adaptive_sketch(256, 4, n_shards=2, items=items, device="cpu",
                              router=TierRouter("sketch",
                                                (TIER_HOST, TIER_DEVICE),
                                                force=tier)).adaptive_ds
    ref = j_adaptive_sketch(256, 4, n_shards=2, items=items,
                            router=JRouter("sketch", ("host", "device"),
                                           force=tier)).adaptive_ds
    ctx = {}
    for _ in range(14):
        ms, ins = tbs._gen_update(rng, int(rng.integers(1, 7)), ctx)
        assert port.update_batch(ms, ins) == ref.update_batch(ms, ins)
        ms, ins = tbs._gen_read(rng, int(rng.integers(1, 5)), ctx)
        assert port.read_batch(ms, ins) == ref.read_batch(ms, ins)


def test_flat_combining_host_baselines():
    items = _map_items(11)
    fm = fc_map(items)
    host = SequentialSortedMap(items)
    for ms, ins, qm, qi in _map_stream(12, 6):
        for m, i in zip(ms + qm, ins + qi):
            assert fm.execute(m, i) == host.apply(m, i)
    fs = fc_sketch([(1.0, 2.0)])
    assert fs.execute("add", (1.0, 3.0)) is False
    assert fs.execute("count", 1.0) == 5.0
