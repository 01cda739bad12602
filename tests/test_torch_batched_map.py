"""The port's device-resident ordered map against the JAX reference.

Seeded op streams (duplicate keys in a batch, delete-then-reinsert,
assign to an absent key, batches wider than c_max, subnormal and -0.0
keys, a refused overflow batch) go through the reference's
``ShardedMap(use_pallas=False)`` and the port's ``ShardedMap(device=
"cpu")``; after every batch every ``MapState`` field must be equal bit
for bit, and every answer equal — ``range_sum`` within the reference's
stated tolerance (1e-3 + 1e-5·|want|, ``batched_map._result_ok``): it is
a difference of f32 prefix sums, and torch and XLA sum in other orders.
Then the megapass, the one-fetch contract, the atomic refusal, the
transactional guard under a ``FaultPlan``, the copy-per-pass twin, the
registry entry and the sequential oracle.
"""
import math

import numpy as np
import pytest
import torch

from repro.core.batched_map import ShardedMap as JMap
from repro.core.seq_map import SequentialSortedMap as JSeqMap
from repro_torch.core import batched_map as tbm
from repro_torch.core import faults as tfaults
from repro_torch.core import substrate
from repro_torch.core.seq_map import SequentialSortedMap

KR = (0.0, 100.0)


def stream(seed, n_batches, c_max, pool_keys=()):
    """(methods, inputs, read methods, read inputs) batches biased toward
    collisions: the registry's generators plus chains on one key,
    assigns to absent keys, subnormal / -0.0 / boundary keys and batches
    of 2–3 c_max lanes."""
    rng = np.random.default_rng(seed)
    ctx = {"keys": list(pool_keys)}
    out = []
    for b in range(n_batches):
        wide = b % 5 == 4
        k = int(rng.integers(2 * c_max + 1, 3 * c_max + 2)) if wide else \
            int(rng.integers(1, c_max + 3))
        ms, ins = tbm._gen_update(rng, k, ctx)
        if b % 6 == 1 and ins:                   # delete-then-reinsert
            key = ins[0] if ms[0] == "delete" else ins[0][0]
            ms += ["delete", "insert", "assign", "insert"]
            ins += [key, (key, 1.5), (key, 2.5), (key, 3.5)]
        if b % 7 == 2:                           # assign to an absent key
            ms.append("assign")
            ins.append((float(rng.uniform(200, 300)), 9.0))
        if b % 4 == 3:                           # zeros, subnormals, edges
            ms += ["insert", "insert", "insert", "delete", "insert"]
            ins += [(-0.0, 1.0), (1e-41, 2.0), (-1e-40, 3.0), 0.0,
                    (KR[1], 4.0)]
        qm, qi = tbm._gen_read(rng, int(rng.integers(1, 10)), ctx)
        qm += ["lookup", "lookup", "range_count", "range_sum",
               "kth_smallest", "kth_smallest"]
        qi += [-0.0, 1e-42, (-1e-41, 1e-41), (-0.0, 50.0), 0, 10 ** 6]
        out.append((ms, ins, qm, qi))
    return out


def assert_state_equal(jm, tm, where):
    js, ts = jm.state, tm.state
    for name in js._fields:
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        assert a.dtype == b.dtype, (where, name)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f"{where}: MapState.{name}")


def assert_answers(methods, got, want, where):
    assert len(got) == len(want), where
    for m, g, w in zip(methods, got, want):
        if m == "range_sum":
            assert tbm._result_ok(m, g, w), (where, g, w)
        else:
            assert g == w, (where, m, g, w)


def _items(seed, n, lo=0.0, hi=100.0):
    rng = np.random.default_rng(seed)
    keys = rng.uniform(lo, hi, n).astype(np.float32)
    keys[: n // 10] = keys[n // 10: 2 * (n // 10)]      # duplicate keys
    return [(float(k), float(v)) for k, v in
            zip(keys, rng.uniform(-50, 50, n).astype(np.float32))]


@pytest.mark.parametrize("seed,K,c_max", [(0, 1, 4), (1, 2, 4), (2, 4, 8),
                                          (3, 4, 3)])
def test_streams_bit_equal_to_reference(seed, K, c_max):
    items = _items(seed, 60)
    cap = 128
    kw = dict(c_max=c_max, n_shards=K, key_range=KR if K > 1 else None,
              items=items)
    jm = JMap(cap, **kw)
    tm = tbm.ShardedMap(cap, device="cpu", **kw)
    assert_state_equal(jm, tm, "init")
    for b, (ms, ins, qm, qi) in enumerate(stream(seed, 24, c_max,
                                                 [k for k, _ in items])):
        assert tm.update_batch(ms, ins) == jm.update_batch(ms, ins), b
        assert_state_equal(jm, tm, f"batch {b}")
        assert_answers(qm, tm.read_batch(qm, qi), jm.read_batch(qm, qi), b)
        assert tm.items() == jm.items()
        assert len(tm) == len(jm)
        np.testing.assert_array_equal(tm.occupancy_mirror()["sizes_ub"],
                                      jm.occupancy_mirror()["sizes_ub"])


def test_refused_overflow_batch_leaves_both_untouched():
    kw = dict(c_max=4, n_shards=2, key_range=KR, items=_items(5, 30))
    jm, tm = JMap(32, **kw), tbm.ShardedMap(32, device="cpu", **kw)
    before = tbm.clone_state(tm.state)
    mirror = tm.occupancy_mirror()["sizes_ub"].copy()
    batch = tbm._refusal_batch(tm)
    with pytest.raises(ValueError, match="capacity"):
        jm.update_batch(*batch)
    with pytest.raises(ValueError, match="capacity"):
        tm.update_batch(*batch)
    assert_state_equal(jm, tm, "after refusal")
    for a, b in zip(tm.state, before):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tm.occupancy_mirror()["sizes_ub"], mirror)
    with pytest.raises(ValueError, match="capacity"):
        tm.mixed_rounds([("update", *batch)])
    np.testing.assert_array_equal(tm.occupancy_mirror()["sizes_ub"], mirror)
    # the map still works, and still equals the reference
    ms, ins = ["insert", "delete"], [(1.0, 2.0), 1.0]
    assert tm.update_batch(ms, ins) == jm.update_batch(ms, ins)
    assert_state_equal(jm, tm, "after recovery")


@pytest.mark.parametrize("bad", [[("insert", (math.nan, 1.0))],
                                 [("insert", (math.inf, 1.0))],
                                 [("assign", (1.0, math.nan))],
                                 [("upsert", (1.0, 1.0))]])
def test_invalid_ops_raise_before_dispatch(bad):
    tm = tbm.ShardedMap(16, c_max=4, device="cpu")
    before = tbm.clone_state(tm.state)
    with pytest.raises(ValueError):
        tm.update_batch([m for m, _ in bad], [i for _, i in bad])
    for a, b in zip(tm.state, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_rounds_bit_equal_to_reference(seed):
    kw = dict(c_max=4, n_shards=4, key_range=KR, items=_items(10 + seed, 40))
    jm, tm = JMap(128, **kw), tbm.ShardedMap(128, device="cpu", **kw)
    batches = stream(20 + seed, 8, 4, [k for k, _ in kw["items"]])
    for i in range(0, len(batches), 2):
        rounds = []
        for ms, ins, qm, qi in batches[i:i + 2]:
            rounds += [("update", ms, ins), ("read", qm, qi), ("read", [], [])]
        hj, ht = jm.mixed_rounds(rounds), tm.mixed_rounds(rounds)
        for (kind, qm, _), a, b in zip(rounds, ht, hj):
            if kind == "update":
                assert a.result() == b.result(), i
            else:
                assert_answers(qm, a.result(), b.result(), i)
        assert_state_equal(jm, tm, f"megapass {i}")


def test_one_host_fetch_per_read_pass_and_none_per_update(monkeypatch):
    tm = tbm.ShardedMap(128, c_max=4, n_shards=2, key_range=KR,
                        device="cpu")
    real = tbm._host_fetch
    calls = []

    def counting(tree):
        calls.append(1)
        return real(tree)

    monkeypatch.setattr(tbm, "_host_fetch", counting)
    for b, (ms, ins, qm, qi) in enumerate(stream(5, 10, 4)):
        h = tm.update_batch_async(ms, ins)
        assert calls == [], "an update pass fetched"
        tm.read_batch(qm, qi)                  # resolves h in its fetch
        assert len(calls) == 1, b
        h.result()
        assert len(calls) == 1, b
        calls.clear()
    # a megapass shares one fetch across all its handles
    hs = tm.mixed_rounds([("update", ["insert"], [(7.5, 1.0)]),
                          ("read", ["lookup"], [7.5])])
    assert calls == []
    hs[1].result()
    hs[0].result()
    assert len(calls) == 1
    assert hs[1].result()[0] is not None        # the read saw the insert


def test_guarded_dispatch_restores_and_retries():
    plan = tfaults.FaultPlan(seed=3, dispatch_fail_rate=0.3,
                             max_dispatch_failures=20)
    kw = dict(c_max=4, n_shards=2, key_range=KR, items=_items(6, 30),
              device="cpu")
    guarded = tbm.ShardedMap(128, fault_plan=plan, **kw)
    guarded._guard._sleep = lambda s: None
    plain = tbm.ShardedMap(128, **kw)
    for ms, ins, qm, qi in stream(6, 16, 4):
        assert guarded.update_batch(ms, ins) == plain.update_batch(ms, ins)
        assert guarded.read_batch(qm, qi) == plain.read_batch(qm, qi)
        for a, b in zip(guarded.state, plain.state):
            assert torch.equal(a, b)
    assert plan.counters.dispatch_failures > 0
    assert plan.counters.restores == plan.counters.dispatch_failures


def test_clone_per_pass_twin_equals_in_place_and_keeps_old_state():
    kw = dict(c_max=4, n_shards=2, key_range=KR, items=_items(7, 30),
              device="cpu")
    twin = tbm.ShardedMap(128, donate=False, **kw)
    inplace = tbm.ShardedMap(128, **kw)
    for ms, ins, qm, qi in stream(7, 10, 4):
        kept = twin.state
        frozen = tbm.clone_state(kept)
        assert twin.update_batch(ms, ins) == inplace.update_batch(ms, ins)
        assert twin.read_batch(qm, qi) == inplace.read_batch(qm, qi)
        for a, b in zip(kept, frozen):      # the old buffers untouched
            assert torch.equal(a, b)
        for a, b in zip(twin.state, inplace.state):
            assert torch.equal(a, b)


def test_init_from_items_equals_reference_last_write_wins():
    items = _items(8, 80) + [(-0.0, 1.0), (1e-40, 2.0), (0.0, 3.0)]
    for K, kr in ((1, None), (4, KR)):
        jm = JMap(128, c_max=4, n_shards=K, key_range=kr, items=items)
        tm = tbm.ShardedMap(128, c_max=4, n_shards=K, key_range=kr,
                            items=items, device="cpu")
        assert_state_equal(jm, tm, f"K={K}")
    with pytest.raises(ValueError, match="capacity"):
        tbm.ShardedMap(8, c_max=4, items=items, device="cpu")
    with pytest.raises(ValueError, match="finite"):
        tbm.ShardedMap(8, c_max=4, items=[(math.nan, 1.0)], device="cpu")
    with pytest.raises(ValueError, match="key_range"):
        tbm.ShardedMap(8, c_max=4, n_shards=2, device="cpu")
    with pytest.raises(TypeError, match="not a placement"):
        tbm.ShardedMap(8, c_max=4, placement=object(), device="cpu")


def test_sequential_map_equals_reference_oracle():
    items = _items(9, 200) + [(-0.0, 1.0), (0.0, 2.0), (5.0, 1.0),
                              (5.0, 2.0)]
    mine, ref = SequentialSortedMap(items), JSeqMap(items)
    assert mine.items() == ref.items()
    assert [math.copysign(1, k) for k, _ in mine.items()] == \
        [math.copysign(1, k) for k, _ in ref.items()]
    for ms, ins, qm, qi in stream(9, 12, 4):
        assert [mine.apply(m, i) for m, i in zip(ms, ins)] == \
            [ref.apply(m, i) for m, i in zip(ms, ins)]
        assert mine.read_batch(qm, qi) == ref.read_batch(qm, qi)
    assert mine.items() == ref.items()


def test_range_sum_within_the_stated_tolerance_of_a_float64_oracle():
    rng = np.random.default_rng(11)
    n = 20_000
    keys = np.unique(rng.uniform(0, 1000, n).astype(np.float32))
    vals = rng.uniform(0, 10, keys.size).astype(np.float32)
    items = list(zip(keys.tolist(), vals.tolist()))
    tm = tbm.ShardedMap(6000, c_max=16, n_shards=4, key_range=(0.0, 1000.0),
                        items=items, device="cpu")
    oracle = SequentialSortedMap(items)
    lo = rng.uniform(0, 950, 64).astype(np.float32).tolist()
    qi = [(a, a + 50.0) for a in lo] + [(0.0, 1000.0)]
    qm = ["range_sum"] * len(qi)
    assert_answers(qm, tm.read_batch(qm, qi), oracle.read_batch(qm, qi),
                   "probe")


def test_registry_entry_builds_the_port_structure():
    spec = substrate.get("map")
    assert spec.module == "repro_torch.core.batched_map"
    assert "map" in substrate.names() and "sketch" in substrate.names()
    ds = spec.make(device="cpu")
    assert isinstance(ds, tbm.ShardedMap) and ds.supports_megapass
    assert ds.supports_placement and spec.extras["placement"]
    assert spec.megapass
    host = spec.make_host(ds)
    ctx = spec.new_ctx()
    rng = np.random.default_rng(8)
    for _ in range(8):
        ms, ins = spec.gen_update(rng, 6, ctx)
        assert ds.update_batch(ms, ins) == [host.apply(m, i)
                                            for m, i in zip(ms, ins)]
        ms, ins = spec.gen_read(rng, 5, ctx)
        for m, g, w in zip(ms, ds.read_batch(ms, ins),
                           host.read_batch(ms, ins)):
            assert spec.result_ok(m, g, w)
    spec.dump_compare(ds, host)
    with pytest.raises(ValueError):
        ds.update_batch(*spec.refusal_batch(ds))
    assert spec.canon("insert", (1e-41, 2.0)) == (0.0, 2.0)
