"""The port's heap kernels (phases 1, 3, 4) against the JAX reference.

On the CPU the kernel wrappers run their plain PyTorch versions; these are
held element-wise (exact: keys are only compared and moved) against the
reference's XLA twins (``batched_pq._k_smallest``, ``_sift_wavefront``,
``_insert_chunk``, ``_phase4_xla``) and the numpy oracles of
``kernels/*/ref.py``, on the same seeded numpy inputs.  The Pallas kernels
are not called.  The ``gpu`` tests hold each CUDA kernel against its plain
version on the card and skip without one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_pq as jbpq
from repro.kernels.heap_kmin.ref import k_smallest_reference
from repro.kernels.heap_sift.ref import sift_wavefront_reference
from repro_torch.core import batched_pq as tbpq
from repro_torch.kernels import heap_insert, heap_kmin, heap_sift
from repro_torch.kernels._common import depth
from repro_torch.kernels.heap_insert import ref as tinsert_ref
from repro_torch.kernels.heap_insert.ops import replace_head_sorted
from repro_torch.kernels.heap_kmin import ref as tkmin_ref
from repro_torch.kernels.heap_sift import ref as tsift_ref

CAP = 256
MAX_DEPTH = int(np.ceil(np.log2(CAP))) + 1      # the reference's bound
CASES = range(12)

_jk_smallest = jax.jit(jbpq._k_smallest, static_argnames=("c_max",))
_jsift = jax.jit(jbpq._sift_wavefront)


@functools.partial(jax.jit, static_argnames=("c_max",))
def _jprep(a, size, ne, vals, ni, *, c_max):
    """The reference's phases 1–2: the sift and phase-4 inputs."""
    a, size, _, _, starts, active, rem, m_left = jbpq._phases12(
        a, size, ne, vals, ni, c_max=c_max)
    return a, size, starts, active, rem, m_left


@functools.partial(jax.jit, static_argnames=("c_max", "max_depth"))
def _jphase4(a, size, rem, m_left, *, c_max, max_depth):
    return jbpq._phase4_xla(a, size, rem, m_left, c_max=c_max,
                            max_depth=max_depth)


@functools.partial(jax.jit, static_argnames=("c_max", "max_depth"))
def _jinsert_chunk(a, size, vals, m, *, c_max, max_depth):
    return jbpq._insert_chunk(a, size, vals, m, c_max, max_depth)


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


def case_inputs(seed, c_max):
    """Seeded heap + combined batch; sizes cover an empty heap, ne > size,
    a level boundary (inserts crossing it) and a large heap."""
    rng = np.random.default_rng(seed)
    kind = seed % 4
    size = {0: 0, 1: int(rng.integers(1, max(c_max, 2))),
            2: (1 << int(rng.integers(3, 7))) - 1 - int(rng.integers(0, 3)),
            3: int(rng.integers(CAP // 2, CAP - 1 - c_max))}[kind]
    a = random_heap(rng, CAP, size, dup=seed % 2 == 1)
    ne = int(rng.integers(0, c_max + 1))
    ni = int(rng.integers(0, c_max + 1))
    vals = np.full(c_max, np.inf, np.float32)
    vals[:ni] = np.where(rng.random(ni) < 0.3, a[1] if size else 0.0,
                         rng.integers(0, 3000, ni)).astype(np.float32)
    return a, size, ne, vals, ni


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def path_heap(rng, size):
    """The smallest keys (0, 1, 2, ... by depth) down one random path,
    every other node above 1e6 and rising by level, +inf past ``size``."""
    v = np.arange(CAP)
    depth_v = np.floor(np.log2(np.maximum(v, 1)))
    a = (1e6 + depth_v * 1e3 + rng.integers(0, 999, CAP)).astype(np.float32)
    node = 1
    while node <= size:
        a[node] = depth_v[node]
        node = 2 * node + int(rng.integers(2))
    a[v > size] = np.inf
    a[0] = np.inf
    return a


def signed_zero_heap(rng, size):
    """A heap topped with -0.0 and +0.0 in turn, duplicates below."""
    a = random_heap(rng, CAP, size, dup=True)
    top = np.arange(1, 16)
    a[top] = np.where(top > size, a[top],
                      np.where(top % 3 == 0, np.float32(0.0),
                               np.float32(-0.0)))
    return a


@pytest.mark.parametrize("c_max", [4, 8])
@pytest.mark.parametrize("seed", CASES)
def test_k_smallest_matches_xla_twin_and_oracle(seed, c_max):
    a, size, ne, _, _ = case_inputs(seed, c_max)
    ids, vals = heap_kmin.k_smallest(_t(a), _t(size, torch.int32),
                                     _t(ne, torch.int32), c_max=c_max)
    jids, jvals = _jk_smallest(jnp.asarray(a), jnp.int32(size),
                               jnp.int32(ne), c_max=c_max)
    rids, rvals = k_smallest_reference(a, size, ne, c_max)
    for want_ids, want_vals in ((jids, jvals), (rids, rvals)):
        assert np.array_equal(ids.numpy(), np.asarray(want_ids))
        assert np.array_equal(vals.numpy(), np.asarray(want_vals))
    # the port's own copy of the oracle is the same oracle
    pids, pvals = tkmin_ref.k_smallest_reference(a, size, ne, c_max)
    assert np.array_equal(pids, rids) and np.array_equal(pvals, rvals)


@pytest.mark.parametrize("c_max", [4, 8])
@pytest.mark.parametrize("seed", CASES)
def test_sift_and_phase4_match_xla_twins(seed, c_max):
    """Phase 3 and phase 4 on the reference's own phase-2 output."""
    a, size, ne, vals, ni = case_inputs(seed, c_max)
    a2, size2, starts, active, rem, m_left = _jprep(
        jnp.asarray(a), jnp.int32(size), jnp.int32(ne), jnp.asarray(vals),
        jnp.int32(ni), c_max=c_max)
    a2, starts, active = (np.asarray(a2), np.asarray(starts),
                          np.asarray(active))
    size2 = int(size2)

    got = heap_sift.sift_wavefront(_t(a2), _t(size2, torch.int32),
                                   _t(starts, torch.int32), _t(active))
    want = np.asarray(_jsift(jnp.asarray(a2), jnp.int32(size2),
                             jnp.asarray(starts), jnp.asarray(active)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        got.numpy(), sift_wavefront_reference(a2, size2, starts, active))
    assert np.array_equal(
        got.numpy(), tsift_ref.sift_wavefront_reference(a2, size2, starts,
                                                        active))

    a4, s4 = heap_insert.phase4(got.clone(), _t(size2, torch.int32),
                                _t(np.asarray(rem)),
                                _t(np.asarray(m_left), torch.int32))
    ja4, js4 = _jphase4(jnp.asarray(want), jnp.int32(size2), rem, m_left,
                        c_max=c_max, max_depth=MAX_DEPTH)
    assert np.array_equal(a4.numpy(), np.asarray(ja4))
    assert int(s4) == int(js4)
    assert jbpq.check_heap_property(a4.numpy(), int(s4))


@pytest.mark.parametrize("c_max", [4, 8])
@pytest.mark.parametrize("seed", CASES)
def test_insert_chunk_matches_xla_twin(seed, c_max):
    """One level-chunk (all targets on one level) against
    ``_insert_chunk``; ``m = 0`` is the identity."""
    rng = np.random.default_rng(100 + seed)
    a, size, _, vals, _ = case_inputs(seed, c_max)
    lo = size + 1
    room = (2 << (lo.bit_length() - 1)) - lo
    m = int(rng.integers(0, min(room, c_max) + 1))
    chunk = np.sort(np.where(np.arange(c_max) < m,
                             rng.integers(0, 3000, c_max), np.inf)
                    ).astype(np.float32)
    got, gs = heap_insert.insert_chunk(_t(a), _t(size, torch.int32),
                                       _t(chunk), _t(m, torch.int32))
    want, ws = _jinsert_chunk(jnp.asarray(a), jnp.int32(size),
                              jnp.asarray(chunk), jnp.int32(m),
                              c_max=c_max, max_depth=MAX_DEPTH)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(gs) == int(ws) == size + m
    ra, rs = tinsert_ref.insert_chunk_reference(a, size, chunk, m)
    assert np.array_equal(ra, np.asarray(want)) and rs == size + m


def test_replace_head_sorted_matches_reference():
    rng = np.random.default_rng(7)
    rows = np.sort(rng.integers(0, 20, (16, 8)).astype(np.float32), axis=1)
    rows[:, 6:] = np.inf
    x = rng.integers(0, 25, 16).astype(np.float32)
    do = rng.random(16) < 0.7
    got = replace_head_sorted(_t(rows), _t(x), _t(do))
    want = jax.vmap(jbpq._replace_head_sorted)(
        jnp.asarray(rows), jnp.asarray(x), jnp.asarray(do))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [0, 1, 2, 3, 7, 8, 1000, 2 ** 20 - 1,
                                  2 ** 20, 2 ** 31 - 2])
def test_depth_and_chunk_len_are_exact(size):
    s = _t([size], torch.int32)
    got = heap_insert.chunk_len(s, _t([1 << 30], torch.int32))
    lo = size + 1
    assert int(got[0]) == (2 << (lo.bit_length() - 1)) - lo
    assert int(depth(s)[0]) == max(size, 1).bit_length() - 1


def test_wrappers_refuse_non_cuda_non_cpu_tensors():
    """A tensor on neither the CPU nor a CUDA device never reaches a
    launch: the wrapper raises."""
    a = torch.full((1, 8), float("inf"), device="meta")
    size = torch.zeros(1, dtype=torch.int32, device="meta")
    ne = torch.ones((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        heap_kmin.k_smallest_sharded(a, size, ne, c_max=2)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("c_max", [1, 2, 4, 8, 16, 31, 32, 33, 64])
@pytest.mark.parametrize("seed", range(8))
def test_cuda_kernels_equal_plain_versions(cuda, seed, c_max):
    """Every width the kernels take up to ``heap_kmin``'s 64: ``heap_insert``
    with one and two values a lane, ``heap_sift`` with one and two warps of
    cursors; empty and tiny heaps take several insert chunks; ``heap_kmin``
    also on a deep-path heap and on signed zeros."""
    a, size, ne, vals, ni = case_inputs(seed, c_max)
    at = _t(a).to(cuda)[None]
    st = _t([size], torch.int32).to(cuda)
    ne_t = _t(ne, torch.int32).to(cuda)
    ids, kv = heap_kmin.k_smallest_sharded(at, st, ne_t, c_max=c_max)
    pids, pv = heap_kmin.k_smallest_plain(at, st, ne_t, c_max)
    assert torch.equal(ids, pids) and torch.equal(kv, pv)

    a2, size2, _, _, starts, active, rem, m_left = tbpq._phases12(
        at.clone(), st, _t([ne], torch.int32).to(cuda),
        _t(vals).to(cuda)[None], _t([ni], torch.int32).to(cuda),
        c_max=c_max, phase1=(pids, pv), n_pull=c_max)
    k_heap, p_heap = a2.clone(), a2.clone()
    heap_sift.sift_wavefront_sharded(k_heap, size2, starts, active)
    heap_sift.sift_wavefront_plain(p_heap, size2, starts, active)
    assert torch.equal(k_heap, p_heap)
    p4 = k_heap.clone()
    _, ks = heap_insert.phase4_sharded(k_heap, size2, rem, m_left)
    _, ps = heap_insert.phase4_plain(p4, size2, rem, m_left)
    assert torch.equal(k_heap, p4) and torch.equal(ks, ps)

    # heap_kmin's cache: the smallest keys down one path (a miss every few
    # steps), a top of -0.0 and +0.0 tied across frontier slots, sizes that
    # cut through the cached levels, and an extract count past the size
    rng = np.random.default_rng(seed)
    size = int(rng.integers(1, CAP))
    for a in (path_heap(rng, size), signed_zero_heap(rng, size)):
        at = _t(a).to(cuda)[None]
        st = _t([size], torch.int32).to(cuda)
        for ne in (c_max, size + 1):
            ne_t = _t(ne, torch.int32).to(cuda)
            ids, kv = heap_kmin.k_smallest_sharded(at, st, ne_t,
                                                   c_max=c_max)
            pids, pv = heap_kmin.k_smallest_plain(at, st, ne_t, c_max)
            assert torch.equal(ids, pids) and torch.equal(kv, pv)
