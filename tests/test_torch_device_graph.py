"""The port's device-resident dynamic graph against the JAX reference.

Seeded op streams (duplicates, self-loops, delete-then-reinsert, more
than 2·c_max pending inserts, batches wider than c_max) go through the
reference's ``DeviceGraph(use_pallas=False)`` and the port's
``DeviceGraph(device="cpu")``; after every batch the per-op results, the
live edge set, every reference ``GraphState`` field (labels, pending
buffer, dirty flag, rebuild counter) and the elimination counter must be
equal.  Then the megapass, the one-fetch contract, the atomic capacity
refusal, the transactional guard under a ``FaultPlan`` and the
clone-per-pass twin.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dynamic_graph as jdyn
from repro.core.device_graph import DeviceGraph as JGraph
from repro_torch.core import device_graph as tdg
from repro_torch.core import faults as tfaults
from repro_torch.core import substrate
from repro_torch.core import dynamic_graph as tdyn
from repro_torch.core.dynamic_graph import DynamicGraph
from repro_torch.kernels.label_prop.ref import components_reference

N = 24
CAP = N * (N - 1) // 2 + 4          # never refuses: room for every edge


def stream(seed, n_batches, c_max, n=N):
    """(methods, inputs, queries) batches biased toward collisions."""
    rng = np.random.default_rng(seed)
    pool = []
    out = []
    for b in range(n_batches):
        wide = b % 5 == 4                      # wider than c_max, inserts
        k = int(rng.integers(2 * c_max + 1, 3 * c_max + 2)) if wide else \
            int(rng.integers(1, c_max + 3))
        ms, ins = [], []
        for _ in range(k):
            if pool and not wide and rng.random() < 0.5:
                e = pool[int(rng.integers(len(pool)))]
            else:
                e = (int(rng.integers(n)), int(rng.integers(n)))
                pool.append(e)
            if rng.random() < 0.08:
                e = (e[0], e[0])               # self-loop
            ms.append("insert" if wide or rng.random() < 0.6 else "delete")
            ins.append(e)
        if b % 7 == 3 and ins:                 # delete-then-reinsert
            ms += ["delete", "insert"]
            ins += [ins[0], ins[0]]
        q = [(int(rng.integers(n)), int(rng.integers(n)))
             for _ in range(int(rng.integers(1, 6)))]
        out.append((ms, ins, q))
    return out


def assert_state_equal(jg, tg, where):
    js, ts = jg.state, tg.state
    for name in js._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(js, name)), getattr(ts, name).numpy(),
            err_msg=f"{where}: GraphState.{name}")


@pytest.mark.parametrize("seed,c_max", [(0, 4), (1, 4), (2, 8)])
def test_streams_bit_equal_to_reference(seed, c_max):
    jg = JGraph(N, edge_capacity=CAP, c_max=c_max, n_shards=2)
    tg = tdg.DeviceGraph(N, edge_capacity=CAP, c_max=c_max, n_shards=2,
                         device="cpu")
    saw_full = saw_overflow = False
    for b, (ms, ins, q) in enumerate(stream(seed, 30, c_max)):
        assert tg.update_batch(ms, ins) == jg.update_batch(ms, ins), b
        assert_state_equal(jg, tg, f"batch {b} after update")
        # an insert-only batch raises dirty_full only by overflowing the
        # 2·c_max pending buffer
        saw_overflow |= bool(tg.state.dirty_full) and "delete" not in ms
        saw_full |= bool(tg.state.dirty_full)
        assert tg.connected_batch(q) == jg.connected_batch(q), b
        assert_state_equal(jg, tg, f"batch {b} after read")
        assert tg.edges() == jg.edges()
        assert tg.full_rebuilds() == jg.full_rebuilds()
        assert tg.eliminated_ops == jg.eliminated_ops
        assert len(tg) == len(jg)
        np.testing.assert_array_equal(
            tg.state.labels.numpy(),
            components_reference(N, sorted(tg.edges())))
    assert saw_full and saw_overflow


@pytest.mark.parametrize("seed", [0, 1])
def test_host_tier_equals_reference_host_tier(seed):
    """The port's ``DynamicGraph`` (its double-jump ``_components`` copied
    as it is) against the reference's: every answer, and the labels at
    the fixpoint."""
    jg, tg = jdyn.DynamicGraph(N), DynamicGraph(N, device="cpu")
    for ms, ins, q in stream(10 + seed, 12, 4):
        for m, e in zip(ms, ins):
            assert tg.apply(m, e) == jg.apply(m, e)
        assert tg.read_batch(["connected"] * len(q), q) == \
            jg.read_batch(["connected"] * len(q), q)
        edges = sorted(tg.edges)
        u = np.asarray([a for a, _ in edges] or [0], np.int32)
        v = np.asarray([b for _, b in edges] or [0], np.int32)
        got = tdyn._components(torch.from_numpy(u), torch.from_numpy(v), N)
        want = jdyn._components(jnp.asarray(u), jnp.asarray(v), n=N)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(),
                                      components_reference(N, edges))


def test_fast_merges_counted_and_insert_only_traffic_never_rebuilds():
    tg = tdg.DeviceGraph(N, edge_capacity=CAP, c_max=4, device="cpu")
    host = DynamicGraph(N, device="cpu")
    for i in range(6):
        e = (i, i + 6)
        assert tg.insert(*e) == host.insert(*e)
        assert tg.connected(0, 6) == host.connected(0, 6)
    assert tg.full_rebuilds() == 0
    assert tg.fast_merges() == 6
    tg.delete(0, 6)
    tg.connected(0, 6)
    assert tg.full_rebuilds() == 1 and tg.fast_merges() == 6
    host.delete(0, 6)
    assert tg.labels() == components_reference(N, sorted(host.edges)).tolist()


@pytest.mark.parametrize("seed", [3, 4])
def test_mixed_rounds_bit_equal_to_reference(seed):
    c_max = 4
    jg = JGraph(N, edge_capacity=CAP, c_max=c_max)
    tg = tdg.DeviceGraph(N, edge_capacity=CAP, c_max=c_max, device="cpu")
    batches = stream(seed, 12, c_max)
    for i in range(0, len(batches), 3):
        rounds = []
        for ms, ins, q in batches[i:i + 3]:
            rounds += [("update", ms, ins), ("read", ["connected"] * len(q),
                                             q)]
        got = [h.result() for h in tg.mixed_rounds(rounds)]
        want = [h.result() for h in jg.mixed_rounds(rounds)]
        assert got == want, i
        assert_state_equal(jg, tg, f"megapass {i}")
        assert tg.edges() == jg.edges()


def test_one_host_fetch_per_read_pass_and_none_per_update(monkeypatch):
    tg = tdg.DeviceGraph(N, edge_capacity=CAP, c_max=4, device="cpu")
    real = tdg._host_fetch
    calls = []

    def counting(tree):
        calls.append(1)
        return real(tree)

    monkeypatch.setattr(tdg, "_host_fetch", counting)
    for b, (ms, ins, q) in enumerate(stream(5, 12, 4)):
        h = tg.update_batch_async(ms, ins)
        assert calls == [], "an update pass fetched"
        tg.connected_batch(q)                  # resolves h in its fetch
        assert len(calls) == 1, b
        h.result()
        assert len(calls) == 1, b
        calls.clear()
    # the lean path (labels current) is one fetch as well
    tg.connected_batch([(0, 1), (2, 3)])
    assert len(calls) == 1
    had = (1, 2) in tg.edges()
    calls.clear()
    # a megapass shares one fetch across all its handles
    hs = tg.mixed_rounds([("update", ["insert"], [(1, 2)]),
                          ("read", ["connected"], [(1, 2)])])
    assert calls == []
    assert [h.result() for h in hs] == [[not had], [True]]
    assert len(calls) == 1


def test_capacity_refusal_is_atomic():
    tg = tdg.DeviceGraph(N, edge_capacity=8, c_max=4, device="cpu")
    assert all(tg.insert_batch([(0, i) for i in range(1, 6)]))
    before = tdg.clone_state(tg.state)
    mirror = dict(tg.occupancy_mirror())
    with pytest.raises(ValueError, match="capacity"):
        tg.insert_batch([(1, i) for i in range(2, 8)])   # 6 > 3 free
    assert tg.occupancy_mirror() == mirror
    for a, b in zip(tg.state, before):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        tg.mixed_rounds([("update", ["insert"] * 4,
                          [(2, i) for i in range(3, 7)])])
    for a, b in zip(tg.state, before):
        assert torch.equal(a, b)
    assert tg.insert_batch([(1, 2), (1, 3), (1, 4)]) == [True] * 3


def test_guarded_dispatch_restores_and_retries():
    plan = tfaults.FaultPlan(seed=3, dispatch_fail_rate=0.3,
                             max_dispatch_failures=20)
    guarded = tdg.DeviceGraph(N, edge_capacity=CAP, c_max=4,
                              fault_plan=plan, device="cpu")
    guarded._guard._sleep = lambda s: None
    plain = tdg.DeviceGraph(N, edge_capacity=CAP, c_max=4, device="cpu")
    for ms, ins, q in stream(6, 16, 4):
        assert guarded.update_batch(ms, ins) == plain.update_batch(ms, ins)
        assert guarded.connected_batch(q) == plain.connected_batch(q)
        for a, b in zip(guarded.state, plain.state):
            assert torch.equal(a, b)
    assert plan.counters.dispatch_failures > 0
    assert plan.counters.restores == plan.counters.dispatch_failures


def test_clone_per_pass_twin_equals_in_place_and_keeps_old_state():
    twin = tdg.DeviceGraph(N, edge_capacity=CAP, c_max=4, donate=False,
                           device="cpu")
    inplace = tdg.DeviceGraph(N, edge_capacity=CAP, c_max=4, device="cpu")
    for ms, ins, q in stream(7, 10, 4):
        kept = twin.state
        frozen = tdg.clone_state(kept)
        assert twin.update_batch(ms, ins) == inplace.update_batch(ms, ins)
        assert twin.connected_batch(q) == inplace.connected_batch(q)
        for a, b in zip(kept, frozen):      # the old buffers untouched
            assert torch.equal(a, b)
        for a, b in zip(twin.state, inplace.state):
            assert torch.equal(a, b)


def test_registry_entry_builds_the_port_structure():
    spec = substrate.get("graph")
    assert spec.module == "repro_torch.core.device_graph"
    ds = spec.make(device="cpu")
    assert isinstance(ds, tdg.DeviceGraph) and ds.supports_megapass
    host = spec.make_host(ds)
    ctx = spec.new_ctx()
    rng = np.random.default_rng(8)
    for _ in range(6):
        ms, ins = spec.gen_update(rng, 5, ctx)
        assert ds.update_batch(ms, ins) == [host.apply(m, i)
                                            for m, i in zip(ms, ins)]
        ms, ins = spec.gen_read(rng, 4, ctx)
        assert ds.read_batch(ms, ins) == host.read_batch(ms, ins)
    spec.dump_compare(ds, host)
    with pytest.raises(ValueError):
        ds.update_batch(*spec.refusal_batch(ds))
    with pytest.raises(TypeError, match="not a placement"):
        tdg.DeviceGraph(N, placement=object(), device="cpu")
