"""The port's PQ megapass against the reference's, on the CPU.

Seeded round lists — multi-row update rounds (inserts with duplicates,
±0.0, subnormals and out-of-range keys, extracts past a shard's size),
``peek_min`` rounds and empty rounds — go through the JAX
``ShardedBatchedPQ(use_pallas=False).mixed_rounds`` and the port's, for
K ∈ {1, 2, 4}, c_max ∈ {4, 8}, hash and key-range routing; every handle's
answers and the final (K, cap) heap stack and sizes must be equal bit for
bit.  A round list with a ``values`` read takes the base per-round
dispatch on both sides.  ``apply_rounds_async`` is held the same way.
Also: padding rows and read rows leave the heap bit-identical, the static
``n_pull = c_max`` of a device-counted pass gives the host bound's bits,
a failed guarded megapass restores into the live buffers, the megapass
engine fuses rounds, the frontier search takes its extract count as a
device tensor, and ``_sharded_mixed_rows`` makes no host read and no
data-dependent shape (the condition for capturing it as a CUDA graph),
shown under a ``TorchDispatchMode`` that raises on them.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro.core import sharded_pq as jspq
from repro_torch.core import batched_pq as tbpq
from repro_torch.core import faults as tfaults
from repro_torch.core import sharded_pq as tspq
from repro_torch.core.pc_pq import pc_megapass_priority_queue
from repro_torch.core.seq_pq import SequentialHeap
from repro_torch.kernels import heap_kmin
from repro_torch.kernels.heap_kmin.ref import k_smallest_reference

KR = (-500.0, 500.0)
POOL = np.array([0.0, -0.0, 1e-40, -1e-42, 3.5, -2.0, 600.0, -900.0, 3.5],
                np.float32)


def keys(rng, n):
    fresh = rng.uniform(-500, 500, n).astype(np.float32)
    return np.where(rng.random(n) < 0.3, rng.choice(POOL, n), fresh)


def round_list(rng, c_max, n_rounds):
    """Update rounds of 1 .. 3 x c_max ops, peek rounds of 1 .. 3 ops and
    empty rounds of either kind, in a seeded order."""
    rounds = []
    for _ in range(n_rounds):
        u = rng.random()
        if u < 0.55:
            n = int(rng.integers(1, 3 * c_max + 1))
            ext = rng.random(n) < rng.uniform(0.2, 0.8)
            ks = keys(rng, n)
            rounds.append(("update",
                           ["extract_min" if e else "insert" for e in ext],
                           [None if e else float(k)
                            for e, k in zip(ext, ks)]))
        elif u < 0.85:
            n = int(rng.integers(1, 4))
            rounds.append(("read", ["peek_min"] * n, [None] * n))
        else:
            rounds.append((("update", "read")[int(rng.integers(2))], [], []))
    return rounds


def bits(xs):
    """A round's answers as f32 bit patterns (None kept; a ``values``
    answer, a list, as a list of them)."""
    return [bits(x) if isinstance(x, list) else
            None if x is None else np.float32(x).view(np.int32).item()
            for x in xs]


def make_pair(K, c_max, key_range, seed, cap=256, **kw):
    rng = np.random.default_rng(seed)
    init = keys(rng, int(rng.integers(0, cap * K // 4)))
    jq = jspq.ShardedBatchedPQ(cap, c_max, n_shards=K, values=init,
                               key_range=key_range)
    tq = tspq.ShardedBatchedPQ(cap, c_max, n_shards=K, values=init,
                               key_range=key_range, device="cpu", **kw)
    return rng, jq, tq


def assert_state(tq, jq):
    a, size = tspq.to_numpy(tq.state)
    np.testing.assert_array_equal(size, np.asarray(jq.state.size))
    np.testing.assert_array_equal(a.view(np.int32),
                                  np.asarray(jq.state.a).view(np.int32))


CASES = [(K, c_max, kr) for K in (1, 2, 4) for c_max in (4, 8)
         for kr in (None, KR)]


@pytest.mark.parametrize("K,c_max,key_range", CASES)
def test_mixed_rounds_bit_equal_to_reference(K, c_max, key_range):
    rng, jq, tq = make_pair(K, c_max, key_range, 10 * K + c_max)
    for n_rounds in (1, 3, 5, 8):
        rounds = round_list(rng, c_max, n_rounds)
        th, jh = tq.mixed_rounds(rounds), jq.mixed_rounds(rounds)
        # consumed in reverse: one shared fetch serves any order
        got = [h.result() for h in th[::-1]][::-1]
        want = [h.result() for h in jh]
        assert [bits(g) for g in got] == [bits(w) for w in want], rounds
        assert_state(tq, jq)
    # a values read sends the whole call to the base per-round dispatch
    rounds = round_list(rng, c_max, 3) + [
        ("read", ["values", "peek_min"], [None, None])]
    got = [h.result() for h in tq.mixed_rounds(rounds)]
    want = [h.result() for h in jq.mixed_rounds(rounds)]
    assert [bits(g) for g in got] == [bits(w) for w in want]
    assert_state(tq, jq)


@pytest.mark.parametrize("K,c_max,key_range", CASES)
def test_apply_rounds_async_bit_equal_to_reference(K, c_max, key_range):
    rng, jq, tq = make_pair(K, c_max, key_range, 100 + 10 * K + c_max)
    for n_rounds in (1, 2, 5):
        rounds = [(int(rng.integers(0, 2 * c_max + 1)),
                   keys(rng, int(rng.integers(0, 2 * c_max + 1))).tolist())
                  for _ in range(n_rounds)]
        got = [h.result() for h in tq.apply_rounds_async(rounds)]
        want = [h.result() for h in jq.apply_rounds_async(rounds)]
        assert [bits(g) for g in got] == [bits(w) for w in want]
        assert_state(tq, jq)


def test_bad_round_kind_raises_and_empty_rounds_dispatch_nothing():
    tq = tspq.ShardedBatchedPQ(64, 4, n_shards=2, values=[1.0],
                               device="cpu")
    with pytest.raises(ValueError, match="round kind"):
        tq.mixed_rounds([("update", ["insert"], [2.0]), ("write", [], [])])
    with pytest.raises(ValueError, match="update method"):
        tq.mixed_rounds([("update", ["peek_min"], [None])])
    assert tq.values() == [1.0]
    hs = tq.mixed_rounds([("update", [], []), ("read", [], [])])
    assert [h.result() for h in hs] == [[], []]
    assert tq.values() == [1.0]


def test_refused_megapass_leaves_heap_and_mirror_as_they_were():
    """The occupancy guard runs over every update row before anything is
    dispatched: a refusal in the last round leaves the earlier rounds
    undone."""
    tq = tspq.ShardedBatchedPQ(16, 4, n_shards=2, values=[1.0, 2.0],
                               device="cpu")
    a0, s0 = tspq.to_numpy(tq.state)
    mirror = {k: np.copy(v) for k, v in tq.occupancy_mirror().items()}
    big = [1000.0 + 2.0 * i for i in range(40)]
    with pytest.raises(ValueError):
        tq.mixed_rounds([("update", ["insert"], [0.5]),
                         ("read", ["peek_min"], [None]),
                         ("update", ["insert"] * 40, big)])
    a1, s1 = tspq.to_numpy(tq.state)
    assert np.array_equal(a0, a1) and np.array_equal(s0, s1)
    for k, v in tq.occupancy_mirror().items():
        assert np.array_equal(np.asarray(v), mirror[k])


def _rows(specs, c_max):
    return torch.from_numpy(tbpq.pack_rows(specs, c_max))


@pytest.mark.parametrize("K", [1, 3])
def test_read_and_padding_rows_leave_the_heap_bit_identical(K):
    """Read rows (peek widths 0 .. c_max, the padding rows' ne = 0) with
    junk in their insert lanes and counts leave ``a`` and ``size``
    bit-identical, and answer the reference's ``_peek_min_impl``."""
    c_max = 8
    rng = np.random.default_rng(K)
    init = keys(rng, 200)
    tq = tspq.ShardedBatchedPQ(256, c_max, n_shards=K, values=init,
                               device="cpu")
    jq = jspq.ShardedBatchedPQ(256, c_max, n_shards=K, values=init)
    a0, s0 = tspq.to_numpy(tq.state)
    specs = [(tspq.MEGA_READ, ne, keys(rng, c_max), int(rng.integers(9)))
             for ne in range(c_max + 1)]
    outs, k_effs = tspq._sharded_mixed_rows(
        tq.state, _rows(specs, c_max), c_max=c_max, n_shards=K)
    a1, s1 = tspq.to_numpy(tq.state)
    np.testing.assert_array_equal(a0.view(np.int32), a1.view(np.int32))
    np.testing.assert_array_equal(s0, s1)
    for (_, ne, _, _), out, k in zip(specs, outs, k_effs):
        want, wk = jspq._peek_min_impl(jq.state, ne, c_max=c_max,
                                       n_shards=K)
        np.testing.assert_array_equal(out.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
        assert int(k) == int(wk)
    assert np.all(np.isinf(outs[0].numpy()))        # a padding row


@pytest.mark.parametrize("seed", range(4))
def test_static_n_pull_gives_the_host_bounds_bits(seed):
    """A pass whose counts stay on the device runs the tail-pull loop
    c_max steps; the masked extra steps change no bit, on the sharded
    pass and the single heap's."""
    c_max, K = 8, 3
    rng = np.random.default_rng(seed)
    init = keys(rng, 60)
    for _ in range(6):
        ne, ni = int(rng.integers(0, c_max + 1)), int(rng.integers(0, 9))
        buf = np.full(c_max, np.inf, np.float32)
        buf[:ni] = keys(rng, ni)
        row = _rows([(tspq.MEGA_UPDATE, ne, buf, ni)], c_max)[0]
        results = []
        for n_pull in (ne, None):
            tq = tspq.ShardedBatchedPQ(64, c_max, n_shards=K, values=init,
                                       device="cpu")
            _, out, k = tspq._sharded_apply_batch(
                tq.state, row, c_max=c_max, n_shards=K, n_pull=n_pull)
            results.append((tq.state.a.clone(), tq.state.size.clone(),
                            out, k))
            st = tbpq.heap_init(128, init, "cpu")
            _, out1, k1 = tbpq.apply_batch_impl(
                st, row, c_max=c_max,
                n_pull=None if n_pull is None else max(ne - ni, 0))
            results.append((st.a, st.size, out1, k1))
        for x, y in zip(results[:2], results[2:]):
            for u, v in zip(x, y):
                assert torch.equal(u.view(torch.int32) if u.is_floating_point()
                                   else u,
                                   v.view(torch.int32) if v.is_floating_point()
                                   else v)


def test_pq_megapass_restore_bit_identical():
    """The reference's ``test_faults.py`` case on the port: a failed
    guarded megapass restores the heap bit for bit, into the live buffers
    (the tensors a captured graph binds), and a clean replay then answers
    the serial schedule."""
    plan = tfaults.FaultPlan(0, dispatch_fail_rate=0.0)
    guard = tfaults.DispatchGuard(plan, max_retries=1, sleep=lambda s: None)
    pq = tspq.ShardedBatchedPQ(64, c_max=4, n_shards=2, guard=guard,
                               device="cpu")
    pq.update_batch(["insert"] * 3, [5.0, 1.0, 9.0])
    a, size = pq.state.a, pq.state.size
    a0, s0 = a.clone(), size.clone()
    v0 = pq.values()
    rounds = [("update", ["insert", "extract_min"], [0.5, None]),
              ("read", ["peek_min", "peek_min"], [None, None])]
    plan.dispatch_fail_rate = 1.0
    with pytest.raises(tfaults.InjectedDispatchError):
        pq.mixed_rounds(rounds)
    assert pq.state.a is a and pq.state.size is size
    assert torch.equal(a.view(torch.int32), a0.view(torch.int32))
    assert torch.equal(size, s0)
    assert pq.values() == v0
    plan.dispatch_fail_rate = 0.0
    hs = pq.mixed_rounds(rounds)
    # extracts before inserts within a round: the extract takes 1.0 and
    # the later peek round observes the freshly inserted 0.5
    assert hs[0].result()[1] == 1.0
    assert hs[1].result() == [0.5, 0.5]
    assert pq.values() == [0.5, 5.0, 9.0]
    assert pq.state.a is a and pq.state.size is size


def test_rebinding_the_state_drops_the_graph_cache():
    pq = tspq.ShardedBatchedPQ(64, c_max=4, n_shards=2, device="cpu")
    pq._graphs[4] = "captured"
    pq.state = pq.state                     # the same tensors: kept
    assert pq._graphs == {4: "captured"}
    pq.state = tspq.ShardedHeapState(pq.state.a.clone(),
                                     pq.state.size.clone())
    assert pq._graphs == {}


def test_megapass_engine_fuses_rounds():
    """``pc_megapass_priority_queue`` lowers several rounds onto one
    dispatch; the answers stay the sequential heap's."""
    eng = pc_megapass_priority_queue(256, c_max=4, n_shards=2,
                                     device="cpu")
    oracle = SequentialHeap()
    rng = np.random.default_rng(3)
    try:
        for _ in range(4):           # bursts: many rounds in the backlog
            vals = [float(np.float32(x)) for x in rng.uniform(-50, 50, 12)]
            futs = [eng.submit("insert", v) for v in vals]
            futs.append(eng.submit("peek_min"))
            futs += [eng.submit("extract_min") for _ in range(9)]
            for f in futs:
                f.result(timeout=120)
            for v in vals:
                oracle.insert(v)
            for _ in range(9):
                oracle.extract_min()
        assert eng.execute("peek_min") == (oracle.a[1] if oracle.size
                                           else None)
    finally:
        eng.close()
    assert sorted(eng.ds.values()) == sorted(oracle.a[1:])
    assert 0 < eng.megapass_dispatches < eng.megapass_rounds
    assert type(eng.ds).supports_megapass


def test_kmin_takes_the_count_as_a_device_tensor():
    """The frontier search reads its extract count from a () int32 tensor
    and gives what the host-int oracle gives; a host int is refused."""
    rng = np.random.default_rng(0)
    size = 40
    a = np.full(64, np.inf, np.float32)
    a[1:size + 1] = np.sort(keys(rng, size))
    at, st = torch.from_numpy(a)[None], torch.tensor([size], dtype=torch.int32)
    for ne in (0, 1, 5, 8, 50):
        ids, vals = heap_kmin.k_smallest_sharded(
            at, st, torch.tensor(ne, dtype=torch.int32), c_max=8)
        rids, rvals = k_smallest_reference(a, size, ne, 8)
        np.testing.assert_array_equal(ids[0].numpy(), rids)
        np.testing.assert_array_equal(vals[0].numpy(), rvals)
    with pytest.raises(TypeError):
        heap_kmin.k_smallest_sharded(at, st, 3, c_max=8)
    with pytest.raises(ValueError):
        heap_kmin.k_smallest_plain(at, st, torch.tensor([3]), 8)


# ---------------------------------------------------------------------------
# Capture safety: no host read, no data-dependent shape
# ---------------------------------------------------------------------------
FORBIDDEN = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
             "_unique", "bincount", "repeat_interleave", "item")


class NoHostRead(TorchDispatchMode):
    """Raises on an op that reads a tensor on the host or whose output
    shape depends on the data: what a CUDA graph's capture cannot hold."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops.add(name)
        if name in FORBIDDEN:
            raise AssertionError(f"capture-unsafe op {func}")
        return func(*args, **(kwargs or {}))


def _opaque(fn, calls):
    """A stand-in for a CUDA kernel's launch: opaque to the mode (the
    plain version's own loop reads the host, the kernel does not)."""
    def run(*args, **kw):
        calls.append(fn.__name__)
        with _disable_current_modes():
            return fn(*args, **kw)
    return run


@pytest.mark.parametrize("key_range", [None, KR])
def test_mixed_rows_make_no_host_read(key_range):
    c_max, K = 8, 4
    rng = np.random.default_rng(7)
    init = keys(rng, 200)
    tq = tspq.ShardedBatchedPQ(256, c_max, n_shards=K, values=init,
                               key_range=key_range, device="cpu")
    twin = tspq.ShardedHeapState(tq.state.a.clone(), tq.state.size.clone())
    specs = []
    for r in range(8):
        ne, ni = int(rng.integers(0, c_max + 1)), int(rng.integers(0, 9))
        buf = np.full(c_max, np.inf, np.float32)
        buf[:ni] = keys(rng, ni)
        specs.append((tspq.MEGA_READ if r % 3 == 1 else tspq.MEGA_UPDATE,
                      ne, buf, ni))
    rows = _rows(specs, c_max)
    calls = []
    phases = tbpq.Phases(heap_kmin.k_smallest_plain,
                         _opaque(tbpq.sift_wavefront_plain, calls),
                         _opaque(tbpq.phase4_plain, calls))
    mode = NoHostRead()
    with mode:
        outs, k_effs = tspq._sharded_mixed_rows(
            tq.state, rows, c_max=c_max, n_shards=K, key_range=key_range,
            phases=phases)
    assert len(calls) == 2 * len(specs)
    assert {"sort", "scatter_add_", "argsort"} & mode.ops
    # the same rows outside the mode, through the kernel phases' CPU path
    want, wk = tspq._sharded_mixed_rows(twin, rows, c_max=c_max,
                                        n_shards=K, key_range=key_range)
    assert torch.equal(outs.view(torch.int32), want.view(torch.int32))
    assert torch.equal(k_effs, wk)
    assert torch.equal(tq.state.a.view(torch.int32),
                       twin.a.view(torch.int32))
    assert torch.equal(tq.state.size, twin.size)


def test_the_mode_catches_a_host_read():
    """The mode has teeth: the eager pass's host bound (``int()`` of a
    device count) and a ``bincount`` raise under it."""
    t = torch.tensor([1, 2, 2], dtype=torch.int32)
    with NoHostRead(), pytest.raises(AssertionError, match="capture"):
        int(t[0])
    with NoHostRead(), pytest.raises(AssertionError, match="capture"):
        torch.bincount(t)
