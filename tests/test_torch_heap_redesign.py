"""CPU emulations of the Hopper designs of ``heap_insert.cu`` and
``heap_sift.cu``, held to the plain versions, the JAX functions and the
numpy oracles.

The CUDA kernels cannot run here, so each design is replayed step by step
in numpy, the way the kernel computes:

- the insert: per level-chunk, the ancestor list the warp prefetches (per
  lane counts, an inclusive scan, each entry's level by counting level
  ends), the chunk as one array of m values in lanes (one or two a lane),
  each InsertSet a segment of it, the swap by a head shuffle, the
  re-insertion point by a masked 64-bit ballot and a popcount, the shift
  by a lane shuffle (with the wrap between a lane's two registers), and
  the changed nodes written back at the end of the chunk.  The prefetched
  nodes must be exactly the nodes the plain version reads and uses, and a
  chunk that read its ancestors before the previous chunk's writes would
  go wrong (shown);
- the sift: each step reads a snapshot taken at its start (the kernel's
  one round trip: the cursor's value on its first step, and its k-level
  subtree), decides up to k levels, writes at most k + 1 nodes; every
  cursor's read and write sets are recorded and must be disjoint from
  every other cursor's writes within the step, for k = 1..5.

Every result is held element-wise (exactly: keys are only compared and
moved) to ``phase4_plain`` / ``sift_wavefront_plain``, to the JAX
``_phase4_xla`` / ``_sift_wavefront`` and to the oracles of
``kernels/heap_insert/ref.py`` (the heap property and the multiset) and
``kernels/heap_sift/ref.py`` (the paper's sequential order SE).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_pq as jbpq
from repro.kernels.heap_sift.ref import sift_wavefront_reference
from repro_torch.core import batched_pq as tbpq
from repro_torch.kernels import heap_insert, heap_kmin, heap_sift
from repro_torch.kernels.heap_insert import ops as insert_ops
from repro_torch.kernels.heap_insert import ref as tinsert_ref

WARP = 32
PREFETCH = 128            # heap_insert.cu's kPrefetch
INF = np.float32(np.inf)
CAP = 203                 # not a multiple of 4: rows start unaligned
MAX_DEPTH = int(np.ceil(np.log2(CAP))) + 1
WIDTHS = [1, 2, 4, 16, 31, 32, 33, 64]


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _depth(v):
    return max(int(v), 1).bit_length() - 1


def random_heap(rng, cap, size, dup):
    """A valid heap: a[v] = a[v // 2] + increment (+inf past ``size``);
    coarse increments make duplicate keys."""
    a = np.full(cap, np.inf, np.float32)
    if size:
        a[1] = rng.integers(0, 1000)
        inc = (rng.integers(0, 3, size + 1) * 50 if dup
               else rng.integers(0, 1000, size + 1)).astype(np.float32)
        for v in range(2, size + 1):
            a[v] = a[v >> 1] + inc[v]
    return a


# ---------------------------------------------------------------------------
# heap_insert: the warp's level-chunk descent
# ---------------------------------------------------------------------------
def ancestors(lo_c, hi_c):
    """The prefetch list of a chunk with targets lo_c..hi_c, as the kernel
    builds it: lane l < d_c counts level l's nodes, an inclusive scan gives
    each level's end, and entry e lies on level d = the number of level
    ends <= e, at node lo_d + (e - the level's start).  Returns (nodes in
    entry order, each level's start)."""
    d_c = _depth(lo_c)
    cnt = np.array([(hi_c >> (d_c - ln)) - (lo_c >> (d_c - ln)) + 1
                    if ln < d_c else 0 for ln in range(WARP)], np.int64)
    incl = np.cumsum(cnt)
    excl = incl - cnt
    total = int(incl[-1])
    assert total <= PREFETCH, (lo_c, hi_c, total)
    nodes = []
    for e in range(total):
        d = int((incl <= e).sum())
        nodes.append((lo_c >> max(d_c - d, 0)) + (e - int(excl[d % WARP])))
    return nodes, excl


def _ballot(pred):
    return sum(1 << i for i, p in enumerate(pred) if p)


def emulate_phase4(a, size, rem, m_left, stale=False):
    """One shard through the kernel's design.  Returns (a, size, chunks),
    chunks = [(lo_c, hi_c, prefetched nodes)].  ``stale``: every chunk
    reads its ancestors from the heap as it stood at launch (before the
    earlier chunks' writes) -- the hazard the kernel's __syncwarp closes."""
    a = a.copy()
    at_launch = a.copy()
    C = len(rem)
    vpl = 1 if C <= WARP else 2
    n = vpl * WARP
    t = np.arange(n)
    lane = t % WARP
    sz, left, off = int(size), min(int(m_left), C), 0
    chunks = []
    while left > 0:
        lo_c = sz + 1
        d_c = _depth(lo_c)
        m = min(left, (2 << d_c) - lo_c)
        hi_c = sz + m
        nodes, excl = ancestors(lo_c, hi_c)
        src = at_launch if stale else a
        pf = np.array([src[v] for v in nodes], np.float32)   # one round trip
        S = np.where(t < m, rem[np.minimum(off + t, C - 1)], INF)
        writes = []
        for d in range(d_c):
            s = d_c - d
            lo_d = lo_c >> s
            v = (lo_c + t) >> s
            first = v << s
            seg_lo = np.maximum(first, lo_c) - lo_c
            seg_hi = np.minimum(first + (1 << s) - 1, hi_c) - lo_c
            av = np.array([pf[excl[d] + v[i] - lo_d] if i < m else INF
                           for i in range(n)], np.float32)
            le = _ballot((t < m) & (S <= av))
            # the lane shuffle by one: lane 31 of register i takes lane 0
            # of register i + 1 (+inf past the last register)
            reg = S.reshape(vpl, WARP)
            sh = np.roll(reg, -1, axis=1)
            wrap = np.concatenate([sh[1:, WARP - 1], [INF]])
            nxt = np.where(lane.reshape(vpl, WARP) < WARP - 1, sh,
                           wrap[:, None]).reshape(n)
            head = reg[seg_lo // WARP, seg_lo % WARP]      # lane_get
            new = S.copy()
            for i in range(m):
                if head[i] < av[i]:
                    seg = ((2 << int(seg_hi[i])) - 1) & ~((2 << int(seg_lo[i]))
                                                        - 1)
                    ins = bin(le & seg).count("1")
                    j = i - seg_lo[i]
                    new[i] = nxt[i] if j < ins else (av[i] if j == ins
                                                     else S[i])
                    if j == 0:
                        writes.append((int(v[i]), head[i]))
            S = new
        writes += [(lo_c + i, S[i]) for i in range(m)]       # the leaves
        for node, val in writes:                             # write-back
            a[node] = val
        chunks.append((lo_c, hi_c, nodes))
        sz, off, left = sz + m, off + m, left - m
    return a, sz, chunks


def plain_reads(monkeypatch, a, size, rem, m_left):
    """Run ``phase4_plain`` on one shard, recording per chunk the nodes it
    reads from the heap (masked lanes read the scratch slot 0)."""
    reads = []
    take, chunk = insert_ops.take, insert_ops.insert_chunk_plain

    def recording_take(x, idx):
        reads[-1].update(int(i) for i in idx.flatten() if i > 0)
        return take(x, idx)

    def recording_chunk(*args):
        reads.append(set())
        return chunk(*args)

    monkeypatch.setattr(insert_ops, "take", recording_take)
    monkeypatch.setattr(insert_ops, "insert_chunk_plain", recording_chunk)
    out, new_size = heap_insert.phase4_plain(
        _t(a)[None], _t([size], torch.int32), _t(rem)[None],
        _t([m_left], torch.int32))
    monkeypatch.undo()
    return out[0].numpy(), int(new_size[0]), reads


def insert_sizes(C):
    """Heap sizes: empty and tiny (several chunks), 2^j - 1 +- C (a batch
    crossing a level), mid-level and nearly full."""
    room = CAP - 1 - C
    out = {0, 1, 2, 3, 7, 8, CAP // 3, room}
    for j in (3, 5, 7):
        out.update({(1 << j) - 1 - C, (1 << j) - 1 + C, (1 << j) - 1})
    return sorted(s for s in out if 0 <= s <= room)


def insert_cases(C):
    """(a, size, rem, m_left): every size above with m in 0..C (all of
    them up to C = 4, then 0, 1, C // 2, C - 1, C), alternately with
    duplicate keys, including keys equal to heap keys."""
    rng = np.random.default_rng(1000 + C)
    ms = range(C + 1) if C <= 4 else sorted({0, 1, C // 2, C - 1, C})
    out = []
    for i, size in enumerate(insert_sizes(C)):
        for m in ms:
            dup = (i + m) % 2 == 1
            a = random_heap(rng, CAP, size, dup)
            vals = rng.integers(0, 3000, m).astype(np.float32)
            if dup and size:
                vals = np.where(rng.random(m) < 0.5,
                                rng.choice(a[1:size + 1], m), vals)
                vals = np.round(vals / 50) * 50
            rem = np.full(C, np.inf, np.float32)
            rem[:m] = np.sort(vals)
            out.append((a, size, rem, m))
    return out


@functools.partial(jax.jit, static_argnames=("c_max",))
def _jphase4_batch(a, size, rem, m_left, *, c_max):
    return jax.vmap(lambda a, s, r, m: jbpq._phase4_xla(
        a, s, r, m, c_max=c_max, max_depth=MAX_DEPTH))(a, size, rem, m_left)


@pytest.mark.parametrize("C", WIDTHS)
def test_insert_emulation_equals_plain_jax_and_oracle(C, monkeypatch):
    cases = insert_cases(C)
    ja, js = _jphase4_batch(
        jnp.asarray(np.stack([c[0] for c in cases])),
        jnp.asarray([c[1] for c in cases], jnp.int32),
        jnp.asarray(np.stack([c[2] for c in cases])),
        jnp.asarray([c[3] for c in cases], jnp.int32), c_max=C)
    ja, js = np.asarray(ja), np.asarray(js)
    n_chunks = 0
    for i, (a, size, rem, m) in enumerate(cases):
        got, gs, chunks = emulate_phase4(a, size, rem, m)
        want, ws, reads = plain_reads(monkeypatch, a, size, rem, m)
        assert np.array_equal(got, want) and gs == ws == size + m
        assert np.array_equal(got, ja[i]) and int(js[i]) == gs
        assert jbpq.check_heap_property(got, gs)
        seq, _ = tinsert_ref.insert_chunk_sequential(a, size, rem[:m])
        assert np.array_equal(np.sort(got[1:gs + 1]), np.sort(seq[1:gs + 1]))
        # one prefetch per chunk: exactly the nodes the plain version reads
        # and uses (it also reads the targets at the leaf level, and drops
        # what it read there)
        assert len(chunks) == len(reads)
        for (lo_c, hi_c, nodes), read in zip(chunks, reads):
            assert len(set(nodes)) == len(nodes)
            assert set(nodes) == read - set(range(lo_c, hi_c + 1))
        n_chunks += len(chunks)
    if C > 1:      # some batches take several chunks
        assert n_chunks > len([c for c in cases if c[3]])


def test_insert_reading_before_the_last_chunks_writes_goes_wrong():
    """Chunks after the first read ancestors that the earlier chunks wrote
    (the root at least).  Reading them as they stood at launch -- what the
    kernel would do without the __syncwarp between a chunk's stores and
    the next chunk's loads -- breaks the result on a near-empty heap."""
    rng = np.random.default_rng(5)
    wrong = []
    for C in (4, 16, 33, 64):
        for size in (0, 1, 2, 6):
            a = random_heap(rng, CAP, size, dup=False)
            rem = np.full(C, np.inf, np.float32)
            rem[:C] = np.sort(rng.integers(0, 3000, C)).astype(np.float32)
            want, ws = heap_insert.phase4_plain(
                _t(a)[None], _t([size], torch.int32), _t(rem)[None],
                _t([C], torch.int32))
            got, gs, chunks = emulate_phase4(a, size, rem, C)
            assert len(chunks) > 1
            assert np.array_equal(got, want[0].numpy())
            stale, _, _ = emulate_phase4(a, size, rem, C, stale=True)
            if not np.array_equal(stale, want[0].numpy()):
                wrong.append(size)
    # an empty heap's second chunk always reads the root its first wrote
    assert wrong.count(0) == 4 and len(wrong) > 8


@pytest.mark.parametrize("d_c", [0, 1, 5, 19, 20, 30])
def test_insert_prefetch_fits_its_buffer(d_c):
    """At most m - 1 + 2 * d_c ancestors for m <= 64: every chunk of every
    width fits the kernel's 128 entries, the deepest shard included."""
    lo_level = 1 << d_c
    for m in (1, 2, 31, 32, 33, 63, 64):
        for lo_c in {lo_level, lo_level + 1, 3 * lo_level // 2 - 1,
                     2 * lo_level - m}:
            if lo_c < lo_level or lo_c + m - 1 > 2 * lo_level - 1:
                continue
            nodes, _ = ancestors(lo_c, lo_c + m - 1)
            assert len(nodes) <= m - 1 + 2 * d_c <= PREFETCH
            want = {v >> s for s in range(1, d_c + 1)
                    for v in range(lo_c, lo_c + m)}
            assert set(nodes) == want


# ---------------------------------------------------------------------------
# heap_sift: k levels a round trip
# ---------------------------------------------------------------------------
def emulate_sift(a, size, starts, active, k):
    """The kernel's steps: each moving cursor reads, from the snapshot at
    the step's start, its value (first step) and the k levels below its
    node, entry e of the subtree at level log2(e + 2); decides up to k
    levels; writes at most k + 1 nodes.  Asserts
    that no cursor's reads or writes meet another's writes in a step.
    Returns (a, steps)."""
    a = a.copy()
    cap = len(a)
    sz = min(int(size), cap - 1)
    dep = np.array([_depth(p) for p in starts])
    act = np.array(active, bool)
    d_max = int(np.where(act, dep, 0).max()) if act.any() else 0
    delay = d_max - dep
    pos = np.array(starts, np.int64)
    av = np.full(len(starts), INF)
    fresh = np.ones(len(starts), bool)
    step = 0
    while act.any():
        snap = a.copy()
        reads, writes = {}, {}
        for i in np.flatnonzero(act & (step >= delay)):
            rd, wr = set(), {}
            sub = {}
            for e in range((2 << k) - 2):    # a register each
                j = (e + 2).bit_length() - 1
                v = (int(pos[i]) << j) + e + 2 - (1 << j)
                if v <= sz:
                    rd.add(v)
                sub[v] = snap[v] if v <= sz else INF
            if fresh[i]:
                rd.add(int(pos[i]))
                av[i] = snap[pos[i]]
                fresh[i] = False
            p, go = int(pos[i]), True
            for _ in range(k):
                lv, rv = sub[2 * p], sub[2 * p + 1]
                wv = lv if lv <= rv else rv
                if not wv < av[i]:
                    go = False
                    break
                wr[p] = wv
                p = 2 * p if lv <= rv else 2 * p + 1
            if p != pos[i]:
                wr[p] = av[i]
            assert len(wr) <= k + 1
            reads[i], writes[i] = rd, wr
            pos[i], act[i] = p, go
        for i in writes:
            for j in writes:
                if i != j:
                    assert not (reads[i] | set(writes[i])) & set(writes[j]), \
                        (step, i, j)
        for wr in writes.values():
            for v, val in wr.items():
                a[v] = val
        step += 1
    return a, step


def sift_cases(c, seed):
    """A real phase-1 frontier (the ne smallest nodes: nested starts at
    consecutive depths) refilled by phase 2, on a heap whose size cuts
    across the paths; duplicate keys on odd seeds.  Returns (a, size,
    starts, active)."""
    rng = np.random.default_rng([c, seed])
    size = int(rng.integers(max(c, 3), CAP - 1))
    a = random_heap(rng, CAP, size, dup=seed % 2 == 1)
    ne = int(rng.integers(1, c + 1))
    ni = int(rng.integers(0, ne + 1)) if seed % 3 else 0
    vals = np.full(c, np.inf, np.float32)
    vals[:ni] = rng.integers(0, 3000, ni).astype(np.float32)
    at, st = _t(a)[None], _t([size], torch.int32)
    phase1 = heap_kmin.k_smallest_plain(at, st, ne, c)
    a2, size2, _, _, starts, active, _, _ = tbpq._phases12(
        at.clone(), st, _t([ne], torch.int32), _t(vals)[None],
        _t([ni], torch.int32), c_max=c, phase1=phase1, n_pull=c)
    return (a2[0].numpy(), int(size2[0]), starts[0].numpy(),
            active[0].numpy())


_jsift = jax.jit(jbpq._sift_wavefront)


@pytest.mark.parametrize("c", [1, 4, 16, 32, 33])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_sift_emulation_disjoint_and_equal_to_plain_jax_and_se(k, c):
    steps_one = steps_k = 0
    for seed in range(6):
        a, size, starts, active = sift_cases(c, seed)
        got, steps = emulate_sift(a, size, starts, active, k)
        want = heap_sift.sift_wavefront_plain(
            _t(a)[None], _t([size], torch.int32),
            _t(starts, torch.int32)[None], _t(active)[None])[0].numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got, np.asarray(_jsift(
            jnp.asarray(a), jnp.int32(size), jnp.asarray(starts),
            jnp.asarray(active))))
        assert np.array_equal(got, sift_wavefront_reference(a, size, starts,
                                                            active))
        steps_k += steps
        steps_one += emulate_sift(a, size, starts, active, 1)[1]
    assert steps_k <= steps_one
    if k > 1 and c > 1:
        assert steps_k < steps_one


def test_sift_emulation_reaches_the_leaves_and_the_size_edge():
    """A lone cursor carrying +inf-like large keys to the bottom: every k
    stops exactly at the last level and at `size`, mid-level."""
    rng = np.random.default_rng(3)
    for size in (1, 2, 3, 6, 100, CAP - 2):
        a = random_heap(rng, CAP, size, dup=False)
        a[1] = 1e9
        starts = np.array([1, 0, 0], np.int32)
        active = np.array([True, False, False])
        want = sift_wavefront_reference(a, size, starts, active)
        for k in range(1, 6):
            got, _ = emulate_sift(a, size, starts, active, k)
            assert np.array_equal(got, want)


def test_heap_ablation_variants_patch_the_kernel_source():
    """``tools/heap_kernels_ablation.py`` builds heap_sift.cu at k = 1..5
    levels a round trip by one textual patch each: the patch must apply
    once, and k = 4 (the source's own) must be the source unchanged."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "heap_kernels_ablation.py"
    spec = importlib.util.spec_from_file_location("heap_ablation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    variants = tool.sources(None)
    built = variants["as_built"]
    assert set(variants) == {"as_built", "k1", "k2", "k3", "k4", "k5"}
    for k in range(1, 6):
        sift = variants[f"k{k}"]["heap_sift.cu"]
        assert sift.count(f"constexpr int kSiftLevels = {k}; ") == 1
        assert variants[f"k{k}"]["heap_insert.cu"] == built["heap_insert.cu"]
    assert variants["k4"] == built
