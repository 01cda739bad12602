"""CPU emulations of the Hopper designs of ``heap_kmin.cu`` and
``sorted_merge.cu``, held to the plain versions, the JAX functions and the
numpy oracles.

The CUDA kernels cannot run here, so each design is replayed in numpy the
way the kernel computes:

- ``heap_kmin``: one launch loads the root and the top T levels with the
  shard's size (one round trip); each step takes the frontier's minimum
  by the kernel's integer argmin (an order-preserving image of the value,
  the lowest lane holding the minimum, slot s in lane s // S of S
  registers a lane) and reads the
  taken node's children from the cache -- every child value a step uses
  must come from it -- and a step whose node has no cached children
  loads that node's k-level subtree into a block of its own (one more
  round trip).  The frontier's slot bookkeeping is the reference's.
  Round trips are counted (1 + misses) for T in {0, 4, 6, 8} and k in
  1..5; T = 0, k = 1 loads exactly the two children a step, as the kernel
  before the cache did.
- ``sorted_merge``: tiles (and the pad CTAs) run as coroutines, started in
  ticket order and stepped in seeded shuffled orders: each tile ranks its
  kept slots (striped over threads, ranks from per-(row, warp) counts,
  each thread's m from its previous kept slot's), publishes its
  aggregate status word, looks back over its shard's earlier tiles a
  window at a time (waiting while a word is not ready), publishes its
  inclusive word, places its kept A and the B runs whose successor it
  holds; the shard's last tile places the B above every kept A; pad CTAs
  wait for each shard's last inclusive word and pad the tail.  The
  status words use the kernel's field layout and the call's epoch, and
  two calls run in a row on one scratch with no reset.  Every output
  slot must be written exactly once.

Every result is held to ``k_smallest_plain`` / ``merge_compact_plain``,
to the JAX ``batched_pq._k_smallest`` / ``merge_compact_xla`` and to the
oracles of ``kernels/heap_kmin/ref.py`` and ``kernels/sorted_merge/ref.py``.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_pq as jbpq
from repro.kernels.sorted_merge import ops as jmerge
from repro_torch.kernels.heap_kmin import k_smallest_plain
from repro_torch.kernels.heap_kmin.ref import k_smallest_reference
from repro_torch.kernels.sorted_merge import ops as merge_ops
from repro_torch.kernels.sorted_merge import merge_compact_plain
from repro_torch.kernels.sorted_merge.ref import merge_compact_reference

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"
INF = np.float32(np.inf)
WARP = 32


def _source_int(name, file):
    found = re.findall(rf"\b{name} = (\d+)[,;]",
                       (CSRC / file).read_text())
    assert len(found) == 1, name
    return int(found[0])


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# heap_kmin: the cached frontier search
# ---------------------------------------------------------------------------
def order_key(x):
    """heap_kmin.cu's order_key: an unsigned image ordered as the float
    compare orders x, with -0.0 and +0.0 one value."""
    b = np.asarray(x, np.float32).view(np.uint32).copy()
    b[(b << np.uint32(1)) == 0] = 0
    return np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000))


def warp_argmin(fv):
    """The kernel's argmin over frontier values ``fv`` (S = ceil(F / 32)
    registers a lane, slot s in lane s // S, register s % S): each lane's
    first lowest key, the warp's smallest key (__reduce_min_sync), the
    lowest lane holding it (a ballot and its first set bit) and that
    lane's register."""
    S = -(-len(fv) // WARP)
    keys = np.full(WARP * S, order_key(INF), np.uint32)
    keys[:len(fv)] = order_key(fv)
    lane_keys = keys.reshape(WARP, S)                  # [lane, register]
    best = lane_keys.min(axis=1)
    owner = int(np.flatnonzero(best == best.min())[0])
    return owner * S + int(lane_keys[owner].argmin())


def child_slot(c, top, sub):
    """heap_kmin.cu's child_slot: the shared index of the left child of
    the node cached at index c, or -1."""
    if c < top:
        return 2 * c if 2 * c < top else -1
    u = (c - top) & (sub - 1)
    return c + u if 2 * u < sub else -1


def emulate_kmin(a, size, ne, c_max, T, k):
    """The kernel's search on one shard.  Returns (ids, vals, round trips,
    the node ids each miss loaded)."""
    cap = len(a)
    top, sub = 1 << T, 2 << k
    node_at = {}                  # shared index -> the heap node it holds
    cache = {}

    def read(v):                  # what a load of node v yields
        return a[v] if v <= size and v < cap else INF

    trips = 1                     # size, the root and the top levels
    for v in range(1, top):
        cache[v], node_at[v] = read(v), v
    F = 2 * c_max + 1
    fv = np.full(F, INF, np.float32)
    fid = np.zeros(F, np.int64)
    fcl = np.full(F, -1, np.int64)
    fv[0] = a[1] if size >= 1 else INF
    fid[0] = 1
    fcl[0] = 2 if 2 < top else -1
    ids = np.zeros(c_max, np.int32)
    vals = np.full(c_max, INF, np.float32)
    nfree, nblk = 1, 0
    loads = []
    for i in range(c_max):
        s = warp_argmin(fv)
        # the integer argmin is the float argmin, first slot on ties
        assert s == int(np.flatnonzero(fv == fv.min())[0]) or \
            not np.isfinite(fv.min())
        v, val, cl = int(fid[s]), fv[s], int(fcl[s])
        if i >= ne or not np.isfinite(val):
            break
        if cl < 0:
            base = top + nblk * sub
            nblk += 1
            trips += 1
            got = []
            for u in range(2, sub):
                j = u.bit_length() - 1
                g = (v << j) + (u - (1 << j))
                cache[base + u], node_at[base + u] = read(g), g
                got.append(g)
            loads.append(got)
            cl = base + 2
        # every child value the step uses comes from the cache
        assert node_at[cl] == 2 * v and node_at[cl + 1] == 2 * v + 1
        fv[s], fid[s], fcl[s] = cache[cl], 2 * v, child_slot(cl, top, sub)
        fv[nfree], fid[nfree] = cache[cl + 1], 2 * v + 1
        fcl[nfree] = child_slot(cl + 1, top, sub)
        nfree += 1
        ids[i], vals[i] = v, val
    return ids, vals, trips, loads


def random_heap(rng, cap, size, dup):
    """a[v] = a[v // 2] + increment up to ``size``, +inf past it; coarse
    increments make duplicate keys tied across frontier slots."""
    a = np.full(cap, np.inf, np.float32)
    if size:
        a[1] = rng.integers(0, 1000)
        inc = (rng.integers(0, 3, size + 1) * 50 if dup
               else rng.integers(0, 1000, size + 1)).astype(np.float32)
        for v in range(2, size + 1):
            a[v] = a[v >> 1] + inc[v]
    return a


def path_heap(rng, cap, size):
    """The smallest keys down one random root-to-leaf path (the search's
    worst case for misses), every other node far above, rising by level."""
    v = np.arange(cap)
    depth = np.floor(np.log2(np.maximum(v, 1)))
    a = (1e6 + depth * 1e3 + rng.integers(0, 999, cap)).astype(np.float32)
    node = 1
    while node <= min(size, cap - 1):
        a[node] = depth[node]
        node = 2 * node + int(rng.integers(2))
    a[v > size] = np.inf
    a[0] = np.inf
    return a


def signed_zero_heap(rng, cap, size):
    """A heap topped with -0.0 and +0.0 in turn (ties across frontier
    slots between zeros of either sign), duplicates below."""
    a = random_heap(rng, cap, size, dup=True)
    top = np.arange(1, min(16, cap))
    zeros = np.where(top % 3 == 0, np.float32(0.0), np.float32(-0.0))
    a[top] = np.where(top <= size, zeros, a[top])
    return a


CAP = 203                 # not a multiple of 4, below the top-8 levels
KMIN_CMAX = [1, 4, 16, 33, 64]


def kmin_cases(seed):
    """(name, a, size): sizes 0-3 and 2^j - 1 +- 1, with size cutting
    through a prefetched level, duplicates, signed zeros, a deep path."""
    rng = np.random.default_rng(seed)
    out = []
    for size in (0, 1, 2, 3, 6, 7, 8, 14, 15, 16, 30, 31, 32, 62, 63, 64,
                 126, 127, 128, CAP - 1):
        dup = size % 2 == 0
        out.append((f"size {size}", random_heap(rng, CAP, size, dup), size))
    out.append(("signed zeros", signed_zero_heap(rng, CAP, CAP - 1),
                CAP - 1))
    out.append(("signed zeros, small", signed_zero_heap(rng, CAP, 9), 9))
    for size in (CAP - 1, 100):
        out.append((f"deep path {size}", path_heap(rng, CAP, size), size))
    return out


@functools.lru_cache(maxsize=None)
def _jkmin(c_max):
    return jax.jit(lambda a, s, n: jbpq._k_smallest(a, s, n, c_max))


def _held_to_plain_jax_oracle(a, size, ne, c_max, ids, vals, what):
    pids, pvals = k_smallest_plain(torch.from_numpy(a)[None],
                                   torch.tensor([size], dtype=torch.int32),
                                   ne, c_max)
    # the plain version returns the frontier minimum (equal to the taken
    # value, but either zero's sign); the JAX scan and the oracle return
    # the taken slot's value, as the kernel does
    np.testing.assert_array_equal(ids, pids[0].numpy(), err_msg=what)
    np.testing.assert_array_equal(vals, pvals[0].numpy(), err_msg=what)
    jids, jvals = _jkmin(c_max)(jnp.asarray(a), jnp.int32(size),
                                jnp.int32(ne))
    np.testing.assert_array_equal(ids, np.asarray(jids), err_msg=what)
    np.testing.assert_array_equal(_bits(vals), _bits(jvals), err_msg=what)
    rids, rvals = k_smallest_reference(a, size, ne, c_max)
    np.testing.assert_array_equal(ids, rids, err_msg=what)
    np.testing.assert_array_equal(_bits(vals), _bits(rvals), err_msg=what)


@pytest.mark.parametrize("c_max", KMIN_CMAX)
def test_kmin_cached_search_equals_plain_jax_and_oracle(c_max):
    """The kernel's T and k as built, every case, ne = 0, ne > size and
    ne = c_max."""
    T = _source_int("kTopLevels", "heap_kmin.cu")
    k = _source_int("kSubLevels", "heap_kmin.cu")
    for name, a, size in kmin_cases(c_max):
        for ne in sorted({0, 1, c_max // 2, c_max, size + 1}):
            ids, vals, trips, loads = emulate_kmin(a, size, ne, c_max, T, k)
            _held_to_plain_jax_oracle(a, size, ne, c_max, ids, vals,
                                      f"{name} ne={ne}")
            assert trips == 1 + len(loads)


@pytest.mark.parametrize("T", [0, 4, 6, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_kmin_round_trips_for_each_T_and_k(T, k):
    """Every T and k gives the same result; round trips are 1 + misses, at
    most one a step; a search down the deep path misses once every k
    levels past the cached top."""
    rng = np.random.default_rng(100 * T + k)
    cases = [("random", random_heap(rng, CAP, CAP - 1, dup=False), CAP - 1),
             ("dups", random_heap(rng, CAP, CAP - 1, dup=True), CAP - 1),
             ("deep path", path_heap(rng, CAP, CAP - 1), CAP - 1)]
    for name, a, size in cases:
        for c_max in (16, 64):
            ids, vals, trips, loads = emulate_kmin(a, size, c_max, c_max, T,
                                                   k)
            _held_to_plain_jax_oracle(a, size, c_max, c_max, ids, vals,
                                      f"{name} T={T} k={k}")
            assert trips == 1 + len(loads) <= 1 + c_max
    a = cases[-1][1]
    L = int((a < 1e6).sum())                 # the path's nodes
    cached = max(T - 1, 0)                   # its nodes with cached children
    trips = emulate_kmin(a, CAP - 1, L, 64, T, k)[2]
    assert trips == 1 + max(-(-(L - cached) // k), 0)


def test_kmin_T0_k1_loads_the_two_children_a_step():
    """T = 0, k = 1 is the kernel before the cache: a miss at every step,
    and each loads exactly the taken node's two children."""
    rng = np.random.default_rng(7)
    a = random_heap(rng, CAP, CAP - 1, dup=True)
    ids, vals, trips, loads = emulate_kmin(a, CAP - 1, 16, 16, 0, 1)
    assert trips == 1 + 16
    assert loads == [[2 * v, 2 * v + 1] for v in ids]


def test_kmin_top_levels_take_the_in_situ_searches_in_one_round_trip():
    """The pass's typical search (2-4 extracts on a large heap of
    uniform keys) stays inside the cached top at the built T: one round
    trip, where the kernel before the cache made 2 + steps."""
    T = _source_int("kTopLevels", "heap_kmin.cu")
    k = _source_int("kSubLevels", "heap_kmin.cu")
    rng = np.random.default_rng(11)
    cap = 1 << 12
    for trial in range(4):
        # a heap of uniform keys in level order, sifted down (Floyd)
        a = np.concatenate([[np.inf], rng.uniform(0, 2 ** 31, cap - 1)])
        a = a.astype(np.float32)
        for v in range((cap - 1) // 2, 0, -1):
            while 2 * v < cap:
                w = 2 * v
                if w + 1 < cap and a[w + 1] < a[w]:
                    w += 1
                if a[v] <= a[w]:
                    break
                a[v], a[w] = a[w], a[v]
                v = w
        for ne in (2, 4):
            assert emulate_kmin(a, cap - 1, ne, 16, T, k)[2] == 1


def test_integer_argmin_is_the_float_argmin_with_first_slot_ties():
    rng = np.random.default_rng(3)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 3.0,
                         -3.0, np.finfo(np.float32).max], np.float32)
    for trial in range(300):
        F = int(rng.integers(1, 2 * 64 + 2))
        if trial % 3 == 0:
            fv = rng.choice(specials, F)
        else:
            fv = rng.integers(-3, 4, F).astype(np.float32)
            fv[rng.random(F) < 0.2] = np.inf
        s = warp_argmin(fv)
        assert s == int(np.flatnonzero(fv == fv.min())[0])
    keys = order_key(np.array([-np.inf, -1.0, -0.0, 0.0, 1e-45, 1.0, np.inf],
                              np.float32))
    assert keys[2] == keys[3] and np.all(np.diff(keys.astype(np.int64))
                                         [[0, 1, 3, 4, 5]] > 0)


def test_kmin_kernel_constants_fit_the_emulation():
    """The kernel is instantiated for every slot count a lane that c_max
    1..MAX_C needs (1..5), and T and k within the emulated ranges."""
    T = _source_int("kTopLevels", "heap_kmin.cu")
    k = _source_int("kSubLevels", "heap_kmin.cu")
    max_c = _source_int("kMaxC", "heap_kmin.cu")
    text = (CSRC / "heap_kmin.cu").read_text()
    for slots in sorted({-(-(2 * c + 1) // WARP)
                         for c in range(1, max_c + 1)}):
        assert (f"launch<{slots}>" in text or
                slots == -(-(2 * max_c + 1) // WARP))
    assert 0 <= T <= 8 and 1 <= k <= 5
    from repro_torch.kernels.heap_kmin import ops
    assert ops.MAX_C == max_c


# ---------------------------------------------------------------------------
# sorted_merge: a single pass with decoupled look-back
# ---------------------------------------------------------------------------
M_SHIFT = _source_int("kMShift", "sorted_merge.cu")
FLAG_SHIFT = _source_int("kFlagShift", "sorted_merge.cu")
EPOCH_SHIFT = _source_int("kEpochShift", "sorted_merge.cu")


def word(epoch, incl, cnt, m):
    return (epoch << EPOCH_SHIFT) | (int(incl) << FLAG_SHIFT) | \
        (m << M_SHIFT) | cnt


def fields(w):
    """(epoch, inclusive, kept count, largest m) of a status word."""
    return (w >> EPOCH_SHIFT, bool((w >> FLAG_SHIFT) & 1),
            w & 0x7FFFFFFF, (w >> M_SHIFT) & 0x7FF)


class Scratch:
    """The wrapper's per-stream scratch: the ticket counter and the status
    words, zeroed once; each call takes the next epoch."""

    def __init__(self, words):
        self.ticket = 0
        self.status = [0] * words
        self.epoch = 0
        self.stale_seen = 0       # reads of an earlier call's word


class Geometry:
    """A scaled-down launch: ``threads`` threads in warps of ``warp``,
    ``items`` slots a thread, look-back windows of ``window`` tiles,
    ``pad`` pad CTAs at most (the kernel: 256, 32, kItems, 128, 64)."""

    def __init__(self, threads=8, warp=4, items=3, window=4, pad=3):
        self.threads, self.warp, self.items = threads, warp, items
        self.window, self.pad = window, pad
        self.tile = threads * items


def merge_ctas(g, inp, out, writes, sc, check_epoch=True):
    """The CTAs of one launch as coroutines; returns (grid, factory)."""
    ak, av, keep, bk, bv, bcount = inp
    K, N = ak.shape
    C = bk.shape[1]
    T = -(-N // g.tile)
    tiles = K * T
    grid = tiles + min(g.pad, tiles)
    epoch = sc.epoch

    def write(k, p, key, val):
        if p < N:
            out[0][k, p], out[1][k, p] = key, val
            writes[k, p] += 1

    def ready(w):
        ep = fields(w)[0]
        if ep not in (0, epoch):
            sc.stale_seen += 1
        return ep == epoch if check_epoch else w != 0

    def valid_b(k):
        return int(np.clip(bcount[k], 0, C))

    def tile(ticket):
        k, t = divmod(ticket, T)
        bc = valid_b(k)
        sB = bk[k, :bc]
        slot = t * g.tile + np.arange(g.items)[:, None] * g.threads + \
            np.arange(g.threads)[None, :]                  # [row, thread]
        kept = (slot < N) & keep[k, np.minimum(slot, N - 1)]
        key = np.where(kept, ak[k, np.minimum(slot, N - 1)], 0)
        val = np.where(kept, av[k, np.minimum(slot, N - 1)], 0)
        # m: each thread's from its previous kept slot's
        m = np.zeros(kept.shape, np.int64)
        for th in range(g.threads):
            mm = 0
            for r in range(g.items):
                if kept[r, th] and mm < bc and sB[mm] < key[r, th]:
                    mm = mm + 1 + int(np.searchsorted(sB[mm + 1:],
                                                      key[r, th], "left"))
                m[r, th] = mm
        assert np.array_equal(m[kept], np.searchsorted(sB, key[kept]))
        # ranks: within (row, warp) by ballot, then the (row, warp) prefix
        warps = g.threads // g.warp
        kw = kept.reshape(g.items, warps, g.warp)
        in_warp = np.cumsum(kw, axis=2) - kw
        cnt = kw.sum(axis=2)                               # [row, warp]
        pre = (np.cumsum(cnt.ravel()) - cnt.ravel()).reshape(cnt.shape)
        ex = (in_warp + pre[:, :, None]).reshape(g.items, g.threads)
        order = np.argsort(slot.ravel())
        assert np.array_equal(
            ex.ravel()[order][kept.ravel()[order]],
            np.arange(int(kept.sum())))      # the rank in slot order
        total = int(kept.sum())
        tile_m = int(m[kept].max()) if total else 0
        yield
        st = k * T
        if t == 0:
            sc.status[st] = word(epoch, True, total, tile_m)
            pc = pm = 0
        else:
            sc.status[st + t] = word(epoch, False, total, tile_m)
            yield
            pc = pm = 0
            j = t - 1
            while True:
                ws = [sc.status[st + j - q] if j - q >= 0 else
                      word(epoch, True, 0, 0) for q in range(g.window)]
                rd = [ready(w) for w in ws]
                inc = [r and fields(w)[1] for r, w in zip(rd, ws)]
                upto = inc.index(True) + 1 if any(inc) else g.window
                if not all(rd[:upto]):
                    yield                                  # spin
                    continue
                pc += sum(fields(w)[2] for w in ws[:upto])
                pm = max([pm] + [fields(w)[3] for w in ws[:upto]])
                if any(inc):
                    break
                j -= g.window
            sc.status[st + t] = word(epoch, True, pc + total,
                                     max(pm, tile_m))
        yield
        mincl = max(pm, tile_m)
        sA = np.empty(total, np.float32)
        for r, th in zip(*np.nonzero(kept)):
            write(k, pc + ex[r, th] + m[r, th], key[r, th], val[r, th])
            sA[ex[r, th]] = key[r, th]
            yield
        for j in range(pm, mincl):
            write(k, pc + j + int(np.searchsorted(sA, sB[j], "left")),
                  sB[j], bv[k, j])
        if t == T - 1:
            for j in range(mincl, bc):
                write(k, pc + total + j, sB[j], bv[k, j])

    def pad(h, H):
        for k in range(K):
            while True:
                w = sc.status[k * T + T - 1]
                if ready(w) and fields(w)[1]:
                    break
                yield
            length = fields(w)[2] + valid_b(k)
            for p in range(length + h * g.threads, N, H * g.threads):
                for q in range(p, min(p + g.threads, N)):
                    write(k, q, INF, INF)
                yield

    def cta(ticket):
        return tile(ticket) if ticket < tiles else pad(ticket - tiles,
                                                       grid - tiles)
    return grid, cta


def run_merge(g, inp, sc, rng, check_epoch=True):
    """One launch: CTAs start in ticket order at seeded times and step in a
    seeded shuffled order.  Returns (keys, vals, writes per slot)."""
    K, N = inp[0].shape
    out = (np.full((K, N), np.nan, np.float32),
           np.full((K, N), np.nan, np.float32))
    writes = np.zeros((K, N), np.int64)
    sc.epoch += 1
    grid, cta = merge_ctas(g, inp, out, writes, sc, check_epoch)
    running, started = [], 0
    for _ in range(10 ** 6):
        if started < grid and (not running or rng.random() < 0.3):
            ticket = sc.ticket
            sc.ticket += 1
            if ticket == grid - 1:
                sc.ticket = 0                    # the last drawer's reset
            running.append(cta(ticket))
            started += 1
        elif running:
            i = int(rng.integers(len(running)))
            try:
                next(running[i])
            except StopIteration:
                running.pop(i)
        else:
            break
    assert started == grid and not running, "the launch did not finish"
    assert sc.ticket == 0
    return out[0], out[1], writes


MERGE_MODES = ("all", "none", "few", "half", "empty", "full")


def merge_case(seed, K, n, c, mode, bc, b_at=None):
    """Seeded inputs shaped as a map pass makes them, junk (unsorted, ±inf,
    NaN) in dropped slots and dead lanes; ``b_at`` puts the B run below or
    above all of A."""
    rng = np.random.default_rng(seed)
    ak = np.full((K, n), np.inf, np.float32)
    av = np.full((K, n), np.inf, np.float32)
    keep = np.zeros((K, n), bool)
    bk = np.full((K, c), np.inf, np.float32)
    bv = np.full((K, c), np.inf, np.float32)
    bcount = np.zeros(K, np.int32)
    for k in range(K):
        b = min(bc, c, n)
        s = 0 if mode == "empty" else n if mode == "full" else \
            int(rng.integers(max(n // 2 - b, 0), n - b + 1))
        keys = (rng.choice(4 * (n + c), s + b, replace=False)
                - 2 * (n + c)).astype(np.float32)
        if b_at is not None:
            keys = np.sort(keys)
            if b_at == "before":
                keys = np.roll(keys, -b)
        vals = rng.uniform(-10, 10, s + b).astype(np.float32)
        ak[k, :s], av[k, :s] = np.sort(keys[:s]), vals[:s]
        kp = np.arange(n) < s
        if mode in ("none", "empty"):
            kp[:] = False
        elif mode == "few":
            kp[rng.choice(s, min(16, s), replace=False)] = False
        elif mode == "full":
            kp[rng.choice(s, b, replace=False)] = False
        elif mode == "half":
            kp &= rng.random(n) < 0.5
        keep[k] = kp
        bk[k, :b], bv[k, :b], bcount[k] = np.sort(keys[s:]), vals[s:], b
        dead = np.flatnonzero(~kp)
        pick = rng.integers(0, 4, dead.size)
        ak[k, dead] = np.select(
            [pick == 0, pick == 1, pick == 2],
            [np.float32(np.inf), np.float32(-np.inf), np.float32(np.nan)],
            rng.uniform(-1e6, 1e6, dead.size).astype(np.float32))
        av[k, dead] = rng.uniform(-1e6, 1e6, dead.size)
        bk[k, b:] = rng.uniform(-1e6, 1e6, c - b)
    return ak, av, keep, bk, bv, bcount


@functools.lru_cache(maxsize=None)
def _jmerge():
    return jax.jit(jax.vmap(jmerge.merge_compact_xla))


def _held(inp, mk, mv, writes, what):
    """Every slot written once; equal bit for bit to the plain version (on
    strided (K, N + 1) row slices, as the map passes them), the JAX twin
    and the oracle."""
    assert np.all(writes == 1), f"{what}: slots written {np.unique(writes)}"
    K, n = inp[0].shape
    rows = []
    for x in inp[:2]:
        blk = torch.full((K, n + 1), -7.0)
        blk[:, :n] = torch.from_numpy(x)
        rows.append(blk[:, :n])
    out = (torch.empty((K, n + 1))[:, :n], torch.empty((K, n + 1))[:, :n])
    pk, pv = merge_compact_plain(*rows, torch.from_numpy(inp[2]),
                                 *(torch.from_numpy(x) for x in inp[3:]),
                                 out=out)
    np.testing.assert_array_equal(_bits(mk), _bits(pk), err_msg=what)
    np.testing.assert_array_equal(_bits(mv), _bits(pv), err_msg=what)
    jk, jv = _jmerge()(*(jnp.asarray(x) for x in inp))
    np.testing.assert_array_equal(_bits(mk), _bits(jk), err_msg=what)
    np.testing.assert_array_equal(_bits(mv), _bits(jv), err_msg=what)
    for k in range(K):
        rk, rv = merge_compact_reference(*(x[k] for x in inp))
        np.testing.assert_array_equal(_bits(mk[k]), _bits(rk), err_msg=what)
        np.testing.assert_array_equal(_bits(mv[k]), _bits(rv), err_msg=what)


@pytest.mark.parametrize("n", [23, 24, 25, 61, 96, 100])
def test_merge_emulation_every_mode_in_shuffled_tile_orders(n):
    """N the tile (24) and one either side, and sizes across several tiles
    and not a multiple of them; every keep mode at b_count 0, 1, 16 and C;
    B below and above all of A; each case in several tile orders, all on
    one scratch, two calls in a row with no reset between them."""
    g = Geometry()
    C = 16
    sc = Scratch(4 * -(-n // g.tile))
    rng = np.random.default_rng(n)
    for i, mode in enumerate(MERGE_MODES):
        for bc in (0, 1, 5, C):
            if mode == "full" and bc > n // 2:
                continue
            for b_at in (None, "before", "after"):
                inp = merge_case(1000 * n + 10 * i + bc, 4, n, C, mode, bc,
                                 b_at)
                for order in range(2):
                    mk, mv, w = run_merge(g, inp, sc, rng)
                    _held(inp, mk, mv, w, f"{mode} bc={bc} {b_at} #{order}")
    assert sc.stale_seen > 0      # earlier calls' words were met and waited


def test_merge_emulation_wide_b_runs_and_the_kernel_window():
    """C = 1,024 lanes (full, half full, below A) at the kernel's warp of
    32 and its look-back window of 128 tiles, across many tiles."""
    g = Geometry(threads=64, warp=32, items=2, window=128, pad=4)
    n, C = 2600, 1024
    sc = Scratch(2 * -(-n // g.tile))
    rng = np.random.default_rng(5)
    for seed, (mode, bc, b_at) in enumerate((("few", C, None),
                                             ("half", C // 2, None),
                                             ("all", C, "before"),
                                             ("none", 7, None))):
        inp = merge_case(seed, 2, n, C, mode, bc, b_at)
        mk, mv, w = run_merge(g, inp, sc, rng)
        _held(inp, mk, mv, w, f"C={C} {mode} {bc} {b_at}")


def test_merge_without_the_epoch_reads_an_earlier_calls_words():
    """The epoch is load-bearing: a look-back that took any written word
    as ready reads the previous call's words and places slots twice or
    not at all, in some tile order (shown)."""
    g = Geometry()
    n = 100
    bad = 0
    for seed in range(12):
        rng = np.random.default_rng(seed)
        sc = Scratch(4 * -(-n // g.tile))
        first = merge_case(seed, 4, n, 16, "half", 16)
        second = merge_case(seed + 50, 4, n, 16, "few", 3)
        run_merge(g, first, sc, rng, check_epoch=False)
        mk, _, w = run_merge(g, second, sc, rng, check_epoch=False)
        want = merge_compact_reference(*(x[0] for x in second))[0]
        bad += not (np.all(w == 1) and np.array_equal(_bits(mk[0]),
                                                       _bits(want)))
    assert bad > 0


def test_status_word_fields_hold_the_kernel_ranges():
    """The kept count (31 bits) holds any int32 N, the m field the widest
    B run, and the wrapper's epochs fit their field."""
    lanes = _source_int("kMaxLanes", "sorted_merge.cu")
    assert M_SHIFT == 31 and (1 << (FLAG_SHIFT - M_SHIFT)) > lanes
    assert EPOCH_SHIFT == FLAG_SHIFT + 1
    assert merge_ops.EPOCHS == 1 << (64 - EPOCH_SHIFT)
    w = word(merge_ops.EPOCHS - 1, True, 2 ** 31 - 1, lanes)
    assert w < 2 ** 64
    assert fields(w) == (merge_ops.EPOCHS - 1, True, 2 ** 31 - 1, lanes)


def test_wrapper_scratch_is_zeroed_once_and_numbers_the_calls():
    """The stream's scratch is made zeroed, grows (zeroed again) only when
    a call needs more words, and restarts its epochs before they run out;
    otherwise each call gets the next epoch on the same buffer."""
    dev = torch.device("cpu")
    key = (dev.index, 12345)
    merge_ops._scratch.pop(key, None)
    try:
        buf, e1 = merge_ops._status_scratch(dev, 12345, 10)
        assert e1 == 1 and torch.all(buf == 0)
        buf[3] = 99
        buf2, e2 = merge_ops._status_scratch(dev, 12345, 8)
        assert e2 == 2 and buf2 is buf and int(buf2[3]) == 99
        buf3, e3 = merge_ops._status_scratch(dev, 12345, 20)
        assert e3 == 1 and buf3.numel() == 20 and torch.all(buf3 == 0)
        merge_ops._scratch[key][1] = merge_ops.EPOCHS - 2
        _, e4 = merge_ops._status_scratch(dev, 12345, 20)
        assert e4 == merge_ops.EPOCHS - 1
        buf5, e5 = merge_ops._status_scratch(dev, 12345, 20)
        assert e5 == 1 and torch.all(buf5 == 0)
    finally:
        merge_ops._scratch.pop(key, None)


def test_ablation_variants_patch_the_kernel_sources():
    """``tools/kmin_merge_ablation.py`` builds its variants by one textual
    patch of each setting; the variant at the built settings is the
    source unchanged."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "kmin_merge_ablation.py"
    spec = importlib.util.spec_from_file_location("km_ablation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    variants = tool.sources(None)
    built = variants["as_built"]
    T = _source_int("kTopLevels", "heap_kmin.cu")
    k = _source_int("kSubLevels", "heap_kmin.cu")
    items = _source_int("kItems", "sorted_merge.cu")
    for t, kk in tool.KMIN_GRID:
        v = variants[f"T{t}k{kk}"]
        assert v["sorted_merge.cu"] == built["sorted_merge.cu"]
        assert tool._setting(v["heap_kmin.cu"], tool.TOP) == t
        assert tool._setting(v["heap_kmin.cu"], tool.SUB) == kk
    for n in tool.MERGE_ITEMS:
        v = variants[f"items{n}"]
        assert v["heap_kmin.cu"] == built["heap_kmin.cu"]
        assert tool._setting(v["sorted_merge.cu"], tool.ITEMS) == n
    for n, i in tool.MERGE_WIDE:
        v = variants[f"threads{n}items{i}"]
        assert v["heap_kmin.cu"] == built["heap_kmin.cu"]
        assert tool._setting(v["sorted_merge.cu"], tool.THREADS) == n
        assert tool._setting(v["sorted_merge.cu"], tool.ITEMS) == i
    fenced = variants["fenced"]["sorted_merge.cu"]
    assert fenced.count("__threadfence();") == \
        built["sorted_merge.cu"].count("__threadfence();") + 1
    assert built["sorted_merge.cu"].count(tool.PUBLISH) == 1
    assert variants["trace"] == dict(built, **{
        "sorted_merge.cu": tool.TRACE_ON + built["sorted_merge.cu"]})
    if (T, k) in tool.KMIN_GRID:
        assert variants[f"T{T}k{k}"] == built
    assert variants[f"items{items}"] == built
