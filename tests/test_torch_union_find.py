"""The port's batched union-find against the JAX reference.

Seeded union streams (chain edges, random links, repeats, batches wider
than c_max so the rounds path runs) go through the reference's
``BatchedUnionFind(use_pallas=False)`` and the port's
``BatchedUnionFind(device="cpu")``: labels and per-op merged flags must be
bit-equal after every batch, and equal to both sequential oracles.  Then
the adaptive tier's repeated-union regression, the one-fetch contract,
atomic refusal, the transactional guard and the clone-per-pass twin.
"""
import numpy as np
import pytest
import torch

from repro.core.batched_union_find import BatchedUnionFind as JUF
from repro.core.seq_union_find import SequentialUnionFind as JSeq
from repro_torch.core import batched_union_find as tuf
from repro_torch.core import faults as tfaults
from repro_torch.core import substrate
from repro_torch.core.combining import TIER_DEVICE, TIER_HOST, TierRouter
from repro_torch.core.pc_union_find import (fc_union_find,
                                            pc_adaptive_union_find,
                                            pc_batched_union_find)
from repro_torch.core.read_opt import AdaptiveReadWrite
from repro_torch.core.seq_union_find import SequentialUnionFind

N = 48


def union_stream(seed, n_batches, c_max, n=N):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        k = int(rng.integers(1, 3 * c_max + 2)) if b % 3 == 2 else \
            int(rng.integers(1, c_max + 1))
        ins = []
        for _ in range(k):
            if ins and rng.random() < 0.15:
                ins.append(ins[int(rng.integers(len(ins)))])    # repeat
                continue
            u = int(rng.integers(n))
            ins.append((u, (u + 1) % n) if rng.random() < 0.5
                       else (u, int(rng.integers(n))))
        out.append(ins)
    return out


READS = (["find", "connected", "components", "find"],
         [5, (3, 40), None, 47])


@pytest.mark.parametrize("seed,c_max", [(0, 4), (1, 8), (2, 3)])
def test_labels_and_flags_bit_equal_to_reference(seed, c_max):
    ju = JUF(N, c_max=c_max)
    tu = tuf.BatchedUnionFind(N, c_max=c_max, device="cpu")
    jseq, tseq = JSeq(N), SequentialUnionFind(N)
    rounds_seen = False
    for b, ins in enumerate(union_stream(seed, 24, c_max)):
        ms = ["union"] * len(ins)
        rounds_seen |= len(ins) > c_max
        got = tu.update_batch(ms, ins)
        assert got == ju.update_batch(ms, ins) == jseq.update_batch(ms, ins) \
            == tseq.update_batch(ms, ins), b
        np.testing.assert_array_equal(tu.state.labels.numpy(),
                                      np.asarray(ju.state.labels))
        assert tu.labels() == jseq.labels() == tseq.labels()
        assert tu.read_batch(*READS) == ju.read_batch(*READS) == \
            tseq.read_batch(*READS)
    assert rounds_seen


def test_sequential_oracle_equals_reference_oracle():
    """The port's forest-based oracle answers as the reference's list
    relabelling one does, op by op and batch by batch."""
    jseq, tseq = JSeq(N), SequentialUnionFind(N)
    rng = np.random.default_rng(3)
    for ins in union_stream(4, 30, 6):
        u, v = ins[0]
        assert tseq.union(u, v) == jseq.union(u, v)
        ms = ["union"] * len(ins)
        assert tseq.update_batch(ms, ins) == jseq.update_batch(ms, ins)
        x = int(rng.integers(N))
        assert tseq.find(x) == jseq.find(x)
        assert tseq.components() == jseq.components()
        assert tseq.labels() == jseq.labels()
    loaded = SequentialUnionFind(N)
    loaded.load_labels(jseq.labels())
    assert loaded.labels() == jseq.labels()
    assert loaded.components() == jseq.components()
    with pytest.raises(ValueError):
        loaded.load_labels([1] + list(range(1, N)))


def _adaptive(router_force):
    uf = tuf.BatchedUnionFind(64, c_max=8, device="cpu")
    host = SequentialUnionFind(64)
    router = TierRouter("unionfind", (TIER_HOST, TIER_DEVICE),
                        force=router_force)
    return AdaptiveReadWrite(uf, host, router=router,
                             structure="unionfind"), router


@pytest.mark.parametrize("first,second", [(TIER_HOST, TIER_DEVICE),
                                          (TIER_DEVICE, TIER_HOST),
                                          (TIER_HOST, TIER_HOST)])
def test_adaptive_repeated_union_matches_sequential_oracle(first, second):
    """Regression: a repeated ``union(40, 41)`` after a tier switch.  The
    reference fuses the host-served replay into the next device batch,
    whose pre-batch rule then reports the repeat True; the port replays
    in a batch of its own and answers False, as the oracle does."""
    ads, router = _adaptive(first)
    oracle = SequentialUnionFind(64)
    assert ads.apply("union", (40, 41)) is oracle.apply("union", (40, 41))
    router.force = second
    assert ads.apply("union", (40, 41)) is False
    assert oracle.apply("union", (40, 41)) is False
    assert ads.update_batch(["union", "union"], [(41, 42), (40, 42)]) == \
        oracle.update_batch(["union", "union"], [(41, 42), (40, 42)])
    assert ads.labels() == oracle.labels()
    assert ads.read_batch(["connected", "components"], [(40, 42), None]) \
        == oracle.read_batch(["connected", "components"], [(40, 42), None])


def test_adaptive_engine_threads_match_oracle():
    """pc_adaptive_union_find under a tier-crossing router, single
    client: every answer equals the sequential oracle's."""
    eng = pc_adaptive_union_find(N, c_max=4, device="cpu")
    eng.router.explore_every = 2
    oracle = SequentialUnionFind(N)
    for ins in union_stream(5, 20, 4):
        for u, v in ins:
            assert eng.execute("union", (u, v)) == oracle.union(u, v)
        x = ins[0][0]
        assert eng.execute("find", x) == oracle.find(x)
    assert eng.adaptive_ds.labels() == oracle.labels()
    assert sum(eng.tier_decisions.values()) > 0
    fc = fc_union_find(N)
    assert fc.execute("union", (1, 2)) is True


def test_one_host_fetch_per_read_batch_and_none_per_update(monkeypatch):
    tu = tuf.BatchedUnionFind(N, c_max=4, device="cpu")
    real = tuf._host_fetch
    calls = []
    monkeypatch.setattr(tuf, "_host_fetch",
                        lambda tree: calls.append(1) or real(tree))
    for ins in union_stream(6, 8, 4):
        h = tu.update_batch_async(["union"] * len(ins), ins)
        assert calls == []
        tu.read_batch(*READS)
        assert len(calls) == 1
        h.result()
        assert len(calls) == 1
        calls.clear()


def test_out_of_range_vertex_refuses_the_whole_batch():
    tu = tuf.BatchedUnionFind(N, c_max=4, device="cpu")
    tu.update_batch(["union"], [(1, 2)])
    before = tu.state.labels.clone()
    with pytest.raises(ValueError):
        tu.update_batch(["union"] * 3, [(3, 4), (5, 6), (0, N)])
    assert torch.equal(tu.state.labels, before)
    with pytest.raises(ValueError):
        tu.update_batch(["find"], [3])


def test_guard_restores_and_clone_twin_keeps_old_state():
    plan = tfaults.FaultPlan(seed=2, dispatch_fail_rate=0.4,
                             max_dispatch_failures=15)
    guarded = tuf.BatchedUnionFind(N, c_max=4, fault_plan=plan,
                                   device="cpu")
    guarded._guard._sleep = lambda s: None
    twin = tuf.BatchedUnionFind(N, c_max=4, donate=False, device="cpu")
    oracle = SequentialUnionFind(N)
    for ins in union_stream(7, 16, 4):
        ms = ["union"] * len(ins)
        kept = twin.state.labels
        frozen = kept.clone()
        want = oracle.update_batch(ms, ins)
        assert guarded.update_batch(ms, ins) == want
        assert twin.update_batch(ms, ins) == want
        assert torch.equal(kept, frozen)
        assert guarded.labels() == twin.labels() == oracle.labels()
    assert plan.counters.dispatch_failures > 0


def test_registry_entry_and_factory_build_the_port_structure():
    spec = substrate.get("unionfind")
    assert spec.module == "repro_torch.core.batched_union_find"
    ds = spec.make(device="cpu")
    assert isinstance(ds, tuf.BatchedUnionFind) and ds.batch_snapshot
    host = spec.make_host(ds)
    ctx = spec.new_ctx()
    rng = np.random.default_rng(9)
    for _ in range(5):
        ms, ins = spec.gen_update(rng, 6, ctx)
        assert ds.update_batch(ms, ins) == host.update_batch(ms, ins)
        ms, ins = spec.gen_read(rng, 5, ctx)
        assert ds.read_batch(ms, ins) == host.read_batch(ms, ins)
    spec.dump_compare(ds, host)
    eng = pc_batched_union_find(N, c_max=4, device="cpu")
    assert eng.execute("union", (1, 2)) is True
    assert eng.execute("connected", (2, 1)) is True
