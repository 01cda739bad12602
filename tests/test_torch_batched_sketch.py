"""The port's device-resident counting/top-k sketch against the JAX
reference.

Seeded add streams (hot keys repeated inside a batch, batches wider than
c_max, subnormal and -0.0 keys) and read batches go through the
reference's ``ShardedSketch(use_pallas=False)`` and the port's
``ShardedSketch(device="cpu")``; after every batch every ``SketchState``
field must be equal bit for bit and every answer equal (the counts are
integer-valued f32, exact while every partial sum stays below 2^24), the
``topk`` lists included.  Then the refusal, the one-fetch contract, the
guard, the copy-per-pass twin, the registry entry and the sequential
oracle's numpy ``topk``.
"""
import numpy as np
import pytest
import torch

from repro.core.batched_sketch import ShardedSketch as JSketch
from repro.core.seq_sketch import SequentialSketch as JSeqSketch
from repro_torch.core import batched_sketch as tbs
from repro_torch.core import faults as tfaults
from repro_torch.core import substrate
from repro_torch.core.seq_sketch import (SequentialSketch, _qk, _qw,
                                         quantize_items)


def stream(seed, n_batches, c_max, pool_keys=()):
    rng = np.random.default_rng(seed)
    ctx = {"keys": list(pool_keys)}
    out = []
    for b in range(n_batches):
        k = int(rng.integers(2 * c_max + 1, 3 * c_max + 2)) if b % 5 == 4 \
            else int(rng.integers(1, c_max + 3))
        ms, ins = tbs._gen_update(rng, k, ctx)
        if b % 4 == 3:                     # zeros and subnormals: one key
            ms += ["add"] * 3
            ins += [(-0.0, 1.0), (1e-41, 2.0), (0.0, 3.0)]
        qm, qi = tbs._gen_read(rng, int(rng.integers(1, 10)), ctx)
        qm += ["count", "topk", "topk"]
        qi += [-0.0, 1, 8]
        out.append((ms, ins, qm, qi))
    return out


def assert_state_equal(js, ts, where):
    for name in js.state._fields:
        a = np.asarray(getattr(js.state, name))
        b = getattr(ts.state, name).numpy()
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f"{where}: SketchState.{name}")


def _items(seed, n):
    rng = np.random.default_rng(seed)
    keys = rng.uniform(0, 100, n).astype(np.float32)
    keys[: n // 8] = keys[n // 8: 2 * (n // 8)]        # repeated keys
    return [(float(k), float(w)) for k, w in
            zip(keys, rng.integers(1, 10, n))]


@pytest.mark.parametrize("seed,K,c_max", [(0, 1, 4), (1, 2, 4), (2, 4, 8),
                                          (3, 4, 3)])
def test_streams_bit_equal_to_reference(seed, K, c_max):
    items = _items(seed, 50)
    kw = dict(c_max=c_max, n_shards=K, topk_max=8, items=items)
    js = JSketch(256, **kw)
    ts = tbs.ShardedSketch(256, device="cpu", **kw)
    assert_state_equal(js, ts, "init")
    for b, (ms, ins, qm, qi) in enumerate(stream(seed, 24, c_max,
                                                 [k for k, _ in items])):
        assert ts.update_batch(ms, ins) == js.update_batch(ms, ins), b
        assert_state_equal(js, ts, f"batch {b}")
        assert ts.read_batch(qm, qi) == js.read_batch(qm, qi), b
        assert ts.counters() == js.counters()
        np.testing.assert_array_equal(ts.occupancy_mirror()["sizes_ub"],
                                      js.occupancy_mirror()["sizes_ub"])


def test_topk_ties_and_short_shards_equal_reference():
    # many equal counts (key order decides) and fewer live counters in a
    # shard than topk_max
    items = [(float(k), 3.0) for k in range(10)] + [(50.5, 7.0)]
    for K, cap in ((1, 16), (4, 16)):
        js = JSketch(cap, c_max=4, n_shards=K, topk_max=8, items=items)
        ts = tbs.ShardedSketch(cap, c_max=4, n_shards=K, topk_max=8,
                               items=items, device="cpu")
        q = list(range(1, 9))
        assert ts.read_batch(["topk"] * 8, q) == \
            js.read_batch(["topk"] * 8, q)
        assert ts.topk(8) == SequentialSketch(items).topk(8)


def test_refusal_is_atomic_and_bad_ops_raise():
    kw = dict(c_max=4, n_shards=2, items=_items(5, 20))
    js, ts = JSketch(24, **kw), tbs.ShardedSketch(24, device="cpu", **kw)
    before = tbs.clone_state(ts.state)
    mirror = ts.occupancy_mirror()["sizes_ub"].copy()
    batch = tbs._refusal_batch(ts)
    for ds in (js, ts):
        with pytest.raises(ValueError, match="capacity"):
            ds.update_batch(*batch)
    for a, b in zip(ts.state, before):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(ts.occupancy_mirror()["sizes_ub"], mirror)
    for ms, ins in ((["add"], [(1.0, 0.5)]), (["add"], [(1.0, 0.0)]),
                    (["bump"], [(1.0, 1.0)]), (["add"], [(np.nan, 1.0)])):
        with pytest.raises(ValueError):
            ts.update_batch(ms, ins)
    with pytest.raises(ValueError, match="topk"):
        ts.read_batch(["topk"], [9])
    assert_state_equal(js, ts, "after refusals")


def test_one_host_fetch_per_read_pass_and_none_per_update(monkeypatch):
    ts = tbs.ShardedSketch(256, c_max=4, n_shards=2, device="cpu")
    real = tbs._host_fetch
    calls = []

    def counting(tree):
        calls.append(1)
        return real(tree)

    monkeypatch.setattr(tbs, "_host_fetch", counting)
    for b, (ms, ins, qm, qi) in enumerate(stream(5, 10, 4)):
        h = ts.update_batch_async(ms, ins)
        assert calls == [], "an update pass fetched"
        ts.read_batch(qm, qi)
        assert len(calls) == 1, b
        h.result()
        assert len(calls) == 1, b
        calls.clear()


def test_guard_restores_and_clone_twin_keeps_old_state():
    plan = tfaults.FaultPlan(seed=4, dispatch_fail_rate=0.3,
                             max_dispatch_failures=20)
    kw = dict(c_max=4, n_shards=2, items=_items(6, 30), device="cpu")
    guarded = tbs.ShardedSketch(256, fault_plan=plan, **kw)
    guarded._guard._sleep = lambda s: None
    twin = tbs.ShardedSketch(256, donate=False, **kw)
    plain = tbs.ShardedSketch(256, **kw)
    for ms, ins, qm, qi in stream(6, 16, 4):
        kept = twin.state
        frozen = tbs.clone_state(kept)
        want = plain.update_batch(ms, ins)
        assert guarded.update_batch(ms, ins) == want
        assert twin.update_batch(ms, ins) == want
        for a, b in zip(kept, frozen):
            assert torch.equal(a, b)
        for ds in (guarded, twin):
            assert ds.read_batch(qm, qi) == plain.read_batch(qm, qi)
            for a, b in zip(ds.state, plain.state):
                assert torch.equal(a, b)
    assert plan.counters.dispatch_failures > 0
    assert plan.counters.restores == plan.counters.dispatch_failures


def test_sequential_sketch_topk_equals_reference_oracle():
    rng = np.random.default_rng(7)
    items = [(float(k), float(w)) for k, w in
             zip(rng.integers(0, 300, 2000), rng.integers(1, 4, 2000))]
    mine, ref = SequentialSketch(items), JSeqSketch(items)
    for k in (1, 2, 5, 17, 100, 299, 300, 301, 10_000):
        assert mine.topk(k) == ref.topk(k), k
    assert SequentialSketch().topk(3) == [] and mine.topk(0) == []
    for ms, ins, qm, qi in stream(8, 10, 4):
        assert mine.update_batch(ms, ins) == ref.update_batch(ms, ins)
        assert mine.read_batch(qm, qi) == ref.read_batch(qm, qi)
    assert mine.items() == ref.items()


@pytest.mark.parametrize("bad", [(1.0, 0.5), (1.0, 0.0), (1.0, np.inf),
                                 (np.nan, 1.0), (1e39, 1.0), (np.inf, 2.0)])
def test_quantize_items_equals_adding_one_by_one(bad):
    rng = np.random.default_rng(11)
    items = [(float(k), float(w)) for k, w in
             zip(rng.integers(-50, 50, 500) * 0.25, rng.integers(1, 9, 500))]
    items += [(-0.0, 1.0), (1e-40, 2.0), (0.0, 3.0), (-1e-39, 1.0),
              (0.1, 4.0), (float(np.float32(0.1)), 1.0), (7.5, 2 ** 25 + 1)]
    one_by_one = {}
    for k, w in items:
        one_by_one[_qk(k)] = one_by_one.get(_qk(k), 0.0) + _qw(w)
    ks, sums = quantize_items(items)
    assert ks.dtype == np.float32
    assert dict(zip(ks.tolist(), sums.tolist())) == one_by_one
    assert ks.tolist() == sorted(one_by_one)
    assert SequentialSketch(items).items() == JSeqSketch(items).items()
    with pytest.raises(ValueError):
        quantize_items(items + [bad])


def test_registry_entry_builds_the_port_structure():
    spec = substrate.get("sketch")
    assert spec.module == "repro_torch.core.batched_sketch"
    ds = spec.make(device="cpu")
    assert isinstance(ds, tbs.ShardedSketch) and not ds.supports_megapass
    host = spec.make_host(ds)
    ctx = spec.new_ctx()
    rng = np.random.default_rng(9)
    for _ in range(8):
        ms, ins = spec.gen_update(rng, 6, ctx)
        assert ds.update_batch(ms, ins) == host.update_batch(ms, ins)
        ms, ins = spec.gen_read(rng, 5, ctx)
        assert ds.read_batch(ms, ins) == host.read_batch(ms, ins)
    spec.dump_compare(ds, host)
    with pytest.raises(ValueError):
        ds.update_batch(*spec.refusal_batch(ds))
    log = [("add", (1.0, 2.0)), ("add", (3.0, 1.0)), ("add", (1.0, 5.0))]
    assert spec.compact(log, host) == [("add", (1.0, 7.0)),
                                       ("add", (3.0, 1.0))]
