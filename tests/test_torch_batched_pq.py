"""The port's single-heap ``BatchedPriorityQueue`` against the reference.

Seeded mixed streams (including oversized batches that slice) go through
the JAX ``BatchedPriorityQueue(use_pallas=False)`` and the port with
``device="cpu"``; heap array, size and answers must be bit-equal after
every apply.  Also: the R-round path equals sequential applies, one
``_host_fetch`` per apply, and the numpy state round trip.
"""
import numpy as np
import pytest
import torch

from repro.core import batched_pq as jbpq
from repro_torch.core import batched_pq as tbpq


def stream(seed, c_max, cap, n_steps=14):
    """(init, [(ne, inserts)]) — duplicates, negative keys, subnormals and
    -0.0 (flushed to +0.0 on entry), batches up to 2·c_max."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 1e-40, -1e-42, 3.5, -2.0, 1e30, -1e30],
                    np.float32)

    def keys(n):
        fresh = rng.uniform(-500, 500, n).astype(np.float32)
        return np.where(rng.random(n) < 0.25, rng.choice(pool, n), fresh)

    n0 = int(rng.integers(0, cap // 3))
    init = keys(n0)
    steps, size = [], n0
    for _ in range(n_steps):
        ne = int(rng.integers(0, 2 * c_max + 1))
        ni = int(rng.integers(0, 2 * c_max + 1))
        size = max(size - ne, 0)
        if size + ni + 1 > cap:
            ni = 0
        size += ni
        steps.append((ne, keys(ni).tolist()))
    return init, steps


def port_state(q):
    a, size = tbpq.to_numpy(q.state)
    return a, size


@pytest.mark.parametrize("seed,c_max,cap", [
    (0, 4, 64), (1, 8, 64), (2, 4, 256), (3, 8, 256), (4, 8, 1024),
    (5, 4, 1024)])
def test_streams_bit_equal_to_reference(seed, c_max, cap):
    init, steps = stream(seed, c_max, cap)
    jq = jbpq.BatchedPriorityQueue(cap, c_max, values=init)
    tq = tbpq.BatchedPriorityQueue(cap, c_max, values=init, device="cpu")
    for ne, ins in steps:
        want = jq.apply(ne, ins)
        got = tq.apply(ne, ins)
        assert got == want
        a, size = port_state(tq)
        assert size == int(jq.state.size)
        assert np.array_equal(a, np.asarray(jq.state.a))
        assert tbpq.check_heap_property(a, size)


@pytest.mark.parametrize("donate", [True, False])
def test_apply_rounds_equals_sequential_applies(donate):
    init, steps = stream(11, 4, 256)
    rounds = [(ne, ins) for ne, ins in steps]
    seq = tbpq.BatchedPriorityQueue(256, 4, values=init, device="cpu")
    fused = tbpq.BatchedPriorityQueue(256, 4, values=init, donate=donate,
                                      device="cpu")
    jq = jbpq.BatchedPriorityQueue(256, 4, values=init)
    want = [seq.apply(ne, ins) for ne, ins in rounds]
    assert fused.apply_rounds(rounds) == want
    assert jq.apply_rounds(rounds) == want
    a, size = port_state(fused)
    assert size == int(jq.state.size)
    assert np.array_equal(a, np.asarray(jq.state.a))
    assert np.array_equal(a, port_state(seq)[0])


def test_one_host_fetch_per_apply(monkeypatch):
    calls = []
    real = tbpq._host_fetch

    def counting(tree):
        calls.append(1)
        return real(tree)

    monkeypatch.setattr(tbpq, "_host_fetch", counting)
    q = tbpq.BatchedPriorityQueue(512, 4, values=list(range(100)),
                                  device="cpu")
    for ne, ins in [(3, [1.5]), (11, list(range(9))), (0, [2.0] * 10),
                    (9, [])]:
        before = len(calls)
        h = q.apply_async(ne, ins)
        assert len(calls) == before          # dispatch never syncs
        h.result()
        h.result()                           # cached
        assert len(calls) == before + 1
    handles = q.apply_rounds_async([(2, [1.0]), (5, []), (0, [3.0])])
    before = len(calls)
    for h in handles:
        h.result()
    assert len(calls) == before + 1          # rounds share one fetch


def test_state_round_trips_through_numpy():
    init, steps = stream(21, 8, 256)
    jq = jbpq.BatchedPriorityQueue(256, 8, values=init)
    for ne, ins in steps[:5]:
        jq.apply(ne, ins)
    a, size = np.asarray(jq.state.a), int(jq.state.size)
    st = tbpq.state_from_numpy(a, size, device="cpu")
    a2, s2 = tbpq.to_numpy(st)
    assert np.array_equal(a2, a) and s2 == size
    assert st.a.dtype == torch.float32 and st.size.dtype == torch.int32
    # continue both packages from the same heap
    tq = tbpq.BatchedPriorityQueue(256, 8, device="cpu")
    tq.state, tq._size = st, size
    for ne, ins in steps[5:]:
        assert tq.apply(ne, ins) == jq.apply(ne, ins)
    assert np.array_equal(port_state(tq)[0], np.asarray(jq.state.a))


def test_empty_heap_and_refusals():
    q = tbpq.BatchedPriorityQueue(16, 4, device="cpu")
    assert q.apply(3, []) == [None, None, None]
    assert q.apply(2, [5.0]) == [None, None]
    assert len(q) == 1 and q.values() == [5.0]
    with pytest.raises(ValueError):
        q.apply(0, [float("inf")])
    with pytest.raises(ValueError):
        tbpq.BatchedPriorityQueue(4, 0, device="cpu")
    with pytest.raises(ValueError):
        tbpq.heap_init(4, values=[1.0] * 4, device="cpu")


def test_reference_helpers():
    ext, rest = tbpq.apply_batch_reference([3.0, 1.0, 2.0], 2, [0.5])
    assert ext == [1.0, 2.0] and rest == [0.5, 3.0]
    a = np.array([np.inf, 1, 2, 3, 0], np.float32)
    assert tbpq.check_heap_property(a, 3)
    assert not tbpq.check_heap_property(a, 4)


def test_capacity_overflow_refused_before_any_slice():
    """The reference lets an overfull batch push ``size`` past the
    capacity; the port refuses it, atomically, and keeps the heap."""
    q = tbpq.BatchedPriorityQueue(16, 4, values=list(range(10)),
                                  device="cpu")
    before = port_state(q)
    for call in (lambda: q.apply(0, [100.0 + i for i in range(6)]),
                 lambda: q.apply(2, [1.0] * 9),      # third slice overflows
                 lambda: q.apply_rounds([(0, [1.0] * 4), (0, [2.0] * 4)])):
        with pytest.raises(ValueError, match="capacity"):
            call()
        a, size = port_state(q)
        assert size == before[1] and np.array_equal(a, before[0])
    assert q.apply(1, [5.0] * 5) == [0.0]            # 14 keys: fits
    assert len(q) == 14 and q._size == 14

