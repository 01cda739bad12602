"""The port's ``ShardedBatchedPQ`` (stacked placement) against the reference.

Seeded mixed streams go through the JAX ``ShardedBatchedPQ(use_pallas=
False)`` and the port with ``device="cpu"`` for K ∈ {1, 2, 4}, hash and
key-range routing; the (K, cap) heap stack, sizes and answers must be
bit-equal after every apply.  Also: routing equals the numpy twins bit for
bit, the occupancy guard refuses atomically, one ``_host_fetch`` per
apply, the rounds path equals sequential applies, and the state round trip.
"""
import numpy as np
import pytest
import torch

from repro.core import sharded_pq as jspq
from repro_torch.core import batched_pq as tbpq
from repro_torch.core import faults as tfaults
from repro_torch.core import sharded_pq as tspq
from repro_torch.core import substrate as tsub

KR = (-500.0, 500.0)


def stream(seed, c_max, cap, K, n_steps=12):
    """(init, [(ne, inserts)]) over keys with duplicates, subnormals,
    -0.0 and out-of-range values (for key-range routing)."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 1e-40, 3.5, -2.0, 600.0, -900.0, 3.5],
                    np.float32)

    def keys(n):
        fresh = rng.uniform(-500, 500, n).astype(np.float32)
        return np.where(rng.random(n) < 0.25, rng.choice(pool, n), fresh)

    init = keys(int(rng.integers(0, cap * K // 4)))
    steps = [(int(rng.integers(0, 2 * c_max + 1)),
              keys(int(rng.integers(0, 2 * c_max + 1))).tolist())
             for _ in range(n_steps)]
    return init, steps


def assert_same(tq, jq):
    a, size = tspq.to_numpy(tq.state)
    assert np.array_equal(size, np.asarray(jq.state.size))
    assert np.array_equal(a, np.asarray(jq.state.a))
    for k in range(tq.n_shards):
        assert np.isinf(a[k, 0])
        assert tbpq.check_heap_property(a[k], int(size[k]))


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("c_max,cap,key_range", [
    (4, 128, None), (8, 256, None), (8, 128, KR)])
def test_streams_bit_equal_to_reference(K, c_max, cap, key_range):
    init, steps = stream(K * 10 + c_max, c_max, cap, K)
    jq = jspq.ShardedBatchedPQ(cap, c_max, n_shards=K, values=init,
                               key_range=key_range)
    tq = tspq.ShardedBatchedPQ(cap, c_max, n_shards=K, values=init,
                               key_range=key_range, device="cpu")
    assert_same(tq, jq)
    for ne, ins in steps:
        try:
            want = jq.apply(ne, ins)
        except ValueError:
            with pytest.raises(ValueError):
                tq.apply(ne, ins)
            continue
        assert tq.apply(ne, ins) == want
        assert_same(tq, jq)
        assert tq.occupancy_mirror()["total"] == jq.occupancy_mirror()["total"]


def test_routing_matches_numpy_twins_and_reference():
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        rng.uniform(-1e6, 1e6, 500), rng.uniform(0, 2 ** 31, 500),
        [0.0, -0.0, 1e-40, -1e-40, 3.4e38, -3.4e38, 1.0, -1.0, 499.9,
         -500.0, 500.0, 7e8]]).astype(np.float32)
    flushed = tspq._flush_host(vals)
    t = torch.tensor(flushed)
    for K in (1, 2, 3, 4, 7, 8):
        got = tspq.route_hash(t, K).numpy()
        assert np.array_equal(got, tspq.route_hash_host(vals, K))
        assert np.array_equal(got, jspq.route_hash_host(vals, K))
        assert np.array_equal(got, np.asarray(jspq.route_hash(flushed, K)))
        for lo, hi in (KR, (0.0, 2.0 ** 31), (-1.0, 1.0)):
            got = tspq.route_range(t, K, lo, hi).numpy()
            assert np.array_equal(got, tspq.route_range_host(vals, K, lo,
                                                             hi))
            assert np.array_equal(got, jspq.route_range_host(vals, K, lo,
                                                             hi))


def test_occupancy_guard_refuses_atomically():
    tq = tspq.ShardedBatchedPQ(16, 4, n_shards=2, values=[1.0, 2.0, 3.0],
                               device="cpu")
    a0, s0 = tspq.to_numpy(tq.state)
    mirror = {k: np.copy(v) for k, v in tq.occupancy_mirror().items()}
    methods, inputs = tspq._refusal_batch(tq)
    with pytest.raises(ValueError):
        tq.update_batch(methods, inputs)
    with pytest.raises(ValueError):
        tq.apply_rounds([(1, [5.0]), (0, inputs)])
    a1, s1 = tspq.to_numpy(tq.state)
    assert np.array_equal(a0, a1) and np.array_equal(s0, s1)
    for k, v in tq.occupancy_mirror().items():
        assert np.array_equal(np.asarray(v), mirror[k])
    assert tq.apply(3, []) == [1.0, 2.0, 3.0]


def test_one_host_fetch_per_apply(monkeypatch):
    calls = []
    real = tbpq._host_fetch

    def counting(tree):
        calls.append(1)
        return real(tree)

    monkeypatch.setattr(tbpq, "_host_fetch", counting)
    tq = tspq.ShardedBatchedPQ(256, 4, n_shards=4,
                               values=list(range(200)), device="cpu")
    for ne, ins in [(3, [1.5]), (13, list(range(10))), (0, [2.0] * 9)]:
        before = len(calls)
        h = tq.apply_async(ne, ins)
        assert len(calls) == before
        h.result()
        assert len(calls) == before + 1
    before = len(calls)
    for h in tq.apply_rounds_async([(2, [1.0]), (6, []), (0, [3.0])]):
        h.result()
    assert len(calls) == before + 1
    before = len(calls)
    peeks = tq.read_batch(["peek_min", "peek_min"], [None, None])
    assert len(calls) == before + 1
    assert peeks == [min(tq.values())] * 2


@pytest.mark.parametrize("K", [1, 4])
def test_apply_rounds_equals_sequential_applies(K):
    init, steps = stream(40 + K, 4, 128, K)
    seq = tspq.ShardedBatchedPQ(128, 4, n_shards=K, values=init,
                                device="cpu")
    fused = tspq.ShardedBatchedPQ(128, 4, n_shards=K, values=init,
                                  device="cpu")
    jq = jspq.ShardedBatchedPQ(128, 4, n_shards=K, values=init)
    want = [seq.apply(ne, ins) for ne, ins in steps]
    assert fused.apply_rounds(steps) == want
    assert jq.apply_rounds(steps) == want
    assert_same(fused, jq)


def test_state_round_trips_through_numpy():
    init, steps = stream(77, 8, 128, 2)
    jq = jspq.ShardedBatchedPQ(128, 8, n_shards=2, values=init)
    for ne, ins in steps[:4]:
        jq.apply(ne, ins)
    a, size = np.asarray(jq.state.a), np.asarray(jq.state.size)
    st = tspq.state_from_numpy(a, size, device="cpu")
    a2, s2 = tspq.to_numpy(st)
    assert np.array_equal(a2, a) and np.array_equal(s2, size)
    tq = tspq.ShardedBatchedPQ(128, 8, n_shards=2, device="cpu")
    tq.state = st
    tq._refresh_sizes(size)
    for ne, ins in steps[4:]:
        assert tq.apply(ne, ins) == jq.apply(ne, ins)
    assert_same(tq, jq)


def test_guarded_dispatch_restores_and_retries():
    """Injected dispatch failures: the in-place pass is rewound from the
    snapshot and retried, so the answers stay the oracle's."""
    plan = tfaults.FaultPlan(seed=3, dispatch_fail_rate=0.3,
                             max_dispatch_failures=5)
    tq = tspq.ShardedBatchedPQ(64, 4, n_shards=2, values=[5.0, 1.0, 3.0],
                               fault_plan=plan, device="cpu")
    tq._guard._sleep = lambda s: None
    oracle = tspq.SequentialBatchedPQ([5.0, 1.0, 3.0], c_max=4)
    rng = np.random.default_rng(0)
    for _ in range(10):
        methods, inputs = tspq._gen_update(rng, 5, {})
        assert tq.update_batch(methods, inputs) == oracle.update_batch(
            methods, inputs)
    tspq._dump_compare(tq, oracle)
    assert tq._guard.counters.restores > 0


def test_registry_entry_builds_the_port_structure():
    spec = tsub.get("pq")
    assert spec.module == "repro_torch.core.batched_pq"
    ds = spec.make(device="cpu")
    assert isinstance(ds, tspq.ShardedBatchedPQ) and tsub.conforms(ds)
    host = spec.make_host(ds)
    rng = np.random.default_rng(1)
    for _ in range(4):
        methods, inputs = spec.gen_update(rng, 6, spec.new_ctx())
        got = ds.update_batch(methods, inputs)
        want = host.update_batch(methods, inputs)
        assert all(spec.result_ok(m, g, w)
                   for m, g, w in zip(methods, got, want))
    spec.dump_compare(ds, host)
    assert tsub.names() == ["graph", "map", "pq", "sketch", "unionfind"]


def oracle_batches(rng, n_batches=12):
    """Mixed batches over duplicates, ±0.0, subnormals, ±inf and 1e39,
    with runs of extracts past the live size."""
    pool = [0.0, -0.0, 1e-40, -1e-42, np.inf, -np.inf, 1e39, -1e39,
            3.5, 3.5, -2.0]
    out = []
    for _ in range(n_batches):
        ext = rng.random() < 0.3
        n = int(rng.integers(20, 48) if ext else rng.integers(0, 24))
        methods, inputs = [], []
        for _ in range(n):
            if rng.random() < (0.8 if ext else 0.4):
                methods.append("extract_min")
                inputs.append(None)
            else:
                methods.append("insert")
                inputs.append(float(pool[rng.integers(len(pool))])
                              if rng.random() < 0.4
                              else float(rng.uniform(-50, 50)))
        out.append((methods, inputs))
    return out


def bits(xs):
    return [None if x is None else repr(x) for x in xs]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("c_max", [None, 1, 3, 16])
def test_sequential_oracle_matches_reference(seed, c_max):
    """The port's heap-backed ``SequentialBatchedPQ`` against the
    reference's sorted-list one: every batch's answers (None padding
    included, -0.0 told from 0.0), ``peek_min`` and ``values`` after
    every batch, the port's oracle built from a numpy array."""
    rng = np.random.default_rng([seed, 7])
    init = np.concatenate([
        np.array([0.0, -0.0, 1e-40, np.inf, -np.inf, 3.5, 3.5], np.float32),
        rng.uniform(-50, 50, int(rng.integers(0, 20))).astype(np.float32)])
    rng.shuffle(init)
    tq = tspq.SequentialBatchedPQ(init, c_max=c_max)
    jq = jspq.SequentialBatchedPQ(init.tolist(), c_max=c_max)
    assert bits(tq.values()) == bits(jq.values())
    for methods, inputs in oracle_batches(rng):
        assert bits(tq.update_batch(methods, inputs)) == bits(
            jq.update_batch(methods, inputs))
        assert len(tq) == len(jq)
        assert bits(tq.values()) == bits(jq.values())
        tp, tv = tq.read_batch(["peek_min", "values"], [None, None])
        jp, jv = jq.read_batch(["peek_min", "values"], [None, None])
        assert bits([tp]) == bits([jp]) and bits(tv) == bits(jv)
        assert bits([tq.apply("peek_min")]) == bits([jq.apply("peek_min")])
