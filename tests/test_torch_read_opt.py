"""The port's read-optimized combining (paper §3.3) on the CPU.

``batched_read_optimized`` over the port's ``DeviceGraph`` under client
threads (conservation of every edge class, final labels against the
union-find oracle); ``MegapassCombiner`` with and without the megapass
against the sequential ``DynamicGraph``; ``AdaptiveReadWrite`` pinned to
each tier against the JAX reference's adaptive tier on the same streams;
``pc_megapass_priority_queue`` against ``SequentialHeap``.
"""
import sys
import threading

import numpy as np
import pytest

from repro.core.device_graph import DeviceGraph as JGraph
from repro.core.dynamic_graph import DynamicGraph as JDyn
from repro.core.read_opt import AdaptiveReadWrite as JAdaptive
from repro.core.combining import TierRouter as JRouter
from repro_torch.core.combining import TIER_DEVICE, TIER_HOST, TierRouter
from repro_torch.core.device_graph import DeviceGraph
from repro_torch.core.dynamic_graph import DynamicGraph
from repro_torch.core.pc_pq import pc_megapass_priority_queue
from repro_torch.core.read_opt import (AdaptiveReadWrite, MegapassCombiner,
                                       batched_read_optimized,
                                       pc_adaptive_graph)
from repro_torch.core.seq_pq import SequentialHeap
from repro_torch.kernels.label_prop.ref import components_reference

N = 32


def _draw(rng, tree, read_pct=60):
    p = rng.random() * 100
    if p < read_pct:
        return "connected", (int(rng.integers(N)), int(rng.integers(N)))
    e = tree[int(rng.integers(len(tree)))]
    return ("insert" if p < read_pct + (100 - read_pct) / 2
            else "delete"), e


def _tree(seed):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    return [(int(perm[i]), int(perm[rng.integers(0, i)]))
            for i in range(1, N)]


def test_batched_read_optimized_threads_conserve_edges_and_labels():
    g = DeviceGraph(N, edge_capacity=N + 8, c_max=4, device="cpu")
    tree = _tree(0)
    g.insert_batch(tree[::2])
    initial = {(min(e), max(e)) for e in tree[::2]}
    engine = batched_read_optimized(g)
    logs = [[] for _ in range(6)]

    def client(tid):
        r = np.random.default_rng([1, tid])
        for _ in range(40):
            m, i = _draw(r, tree)
            logs[tid].append((m, i, engine.execute(m, i)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=client, args=(t,)) for t in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    delta = {}
    for log in logs:
        for m, e, res in log:
            if m != "connected" and res:
                k = (min(e), max(e))
                delta[k] = delta.get(k, 0) + (1 if m == "insert" else -1)
    final = g.edges()
    for e in initial | set(delta) | final:
        want = (e in initial) + delta.get(e, 0)
        assert want in (0, 1) and (e in final) == bool(want), e
    assert g.labels() == components_reference(N, sorted(final)).tolist()
    assert engine.passes > 0 and max(engine.combined_sizes) >= 1


@pytest.mark.parametrize("use_megapass", [True, False])
def test_megapass_combiner_equals_sequential_graph(use_megapass):
    g = DeviceGraph(N, edge_capacity=N + 40, c_max=4, device="cpu")
    host = DynamicGraph(N, device="cpu")
    tree = _tree(2)
    rng = np.random.default_rng(3)
    ops = [_draw(rng, tree, read_pct=50) for _ in range(120)]
    with MegapassCombiner(g, rounds_cap=4,
                          use_megapass=use_megapass) as eng:
        futs = [eng.submit(m, i) for m, i in ops]
        got = [f.result(timeout=120) for f in futs]
    # rounds are a serial schedule in submission order: the sequential
    # graph answers the same
    want = [host.apply(m, i) for m, i in ops]
    assert got == want
    assert g.edges() == host.edges
    assert eng.megapass_rounds >= eng.megapass_dispatches > 0
    if not use_megapass:
        assert eng.megapass_rounds == eng.megapass_dispatches


def _graph_stream(seed, n_batches=14):
    rng = np.random.default_rng(seed)
    tree = _tree(seed)
    out = []
    for _ in range(n_batches):
        k = int(rng.integers(1, 7))
        upd = [_draw(rng, tree, read_pct=0) for _ in range(k)]
        q = [(int(rng.integers(N)), int(rng.integers(N)))
             for _ in range(int(rng.integers(1, 5)))]
        out.append(([m for m, _ in upd], [i for _, i in upd], q))
    return out


@pytest.mark.parametrize("tier", [TIER_HOST, TIER_DEVICE])
def test_adaptive_graph_pinned_tier_equals_reference(tier):
    port = AdaptiveReadWrite(
        DeviceGraph(N, edge_capacity=N + 40, c_max=4, device="cpu"),
        DynamicGraph(N, device="cpu"),
        router=TierRouter("graph", (TIER_HOST, TIER_DEVICE), force=tier),
        structure="graph")
    ref = JAdaptive(JGraph(N, edge_capacity=N + 40, c_max=4), JDyn(N),
                    router=JRouter("graph", ("host", "device"), force=tier),
                    structure="graph")
    for ms, ins, q in _graph_stream(4):
        assert port.update_batch(ms, ins) == ref.update_batch(ms, ins)
        assert port.read_batch(["connected"] * len(q), q) == \
            ref.read_batch(["connected"] * len(q), q)
    assert {tuple(e) for e in port.edges()} == \
        {tuple(e) for e in ref.edges()}


def test_adaptive_graph_tier_crossing_equals_host_oracle():
    eng = pc_adaptive_graph(N, edge_capacity=N + 40, c_max=4, device="cpu")
    eng.router.explore_every = 2
    host = DynamicGraph(N, device="cpu")
    for ms, ins, q in _graph_stream(5, 20):
        for m, i in zip(ms, ins):
            assert eng.execute(m, i) == host.apply(m, i)
        for pair in q:
            assert eng.execute("connected", pair) == host.connected(*pair)
    assert eng.adaptive_ds.edges() == host.edges
    assert min(eng.tier_decisions.values()) > 0


def test_megapass_priority_queue_on_the_cpu():
    eng = pc_megapass_priority_queue(256, c_max=4, n_shards=2, device="cpu")
    oracle = SequentialHeap()
    rng = np.random.default_rng(6)
    try:
        for _ in range(60):        # one op per round: the sequential rule
            if rng.random() < 0.55:
                v = float(np.float32(rng.uniform(-100, 100)))
                eng.execute("insert", v)
                oracle.insert(v)
            else:
                assert eng.execute("extract_min") == oracle.extract_min()
            head = oracle.a[1] if oracle.size else None
            assert eng.execute("peek_min") == head
        # a burst of submits: conservation of the multiset
        vals = [float(np.float32(x)) for x in rng.uniform(-50, 50, 40)]
        futs = [eng.submit("insert", v) for v in vals]
        futs += [eng.submit("extract_min") for _ in range(25)]
        got = [f.result(timeout=120) for f in futs[40:]]
    finally:
        eng.close()
    before = sorted(oracle.a[1:] + vals)
    rest = eng.ds.values()
    assert sorted([g for g in got if g is not None] + rest) == before
    assert eng.megapass_dispatches > 0
