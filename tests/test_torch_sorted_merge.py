"""The port's sorted merge-compact against the JAX reference.

On the CPU ``merge_compact_sharded`` runs its plain PyTorch version; it is
held element for element (bit for bit: the merge only moves f32 values)
against the reference's XLA twin ``merge_compact_xla``, its Pallas kernel
in interpret mode (``merge_compact_sharded(..., interpret=True)``) and the
numpy oracles of both packages, on the same seeded numpy inputs: every
keep mode, b_count from 0 to C, junk (unsorted, ±inf, NaN) in the dropped
slots and dead lanes, an empty A, a merged length of exactly N, signed and
flushed zeros.  The ``gpu`` test holds the CUDA kernel against the plain
version on the card and skips without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sorted_merge import ops as jops
from repro.kernels.sorted_merge.ref import merge_compact_reference
from repro_torch.kernels import sorted_merge
from repro_torch.kernels.sorted_merge import ref as tref
from repro_torch.kernels.sorted_merge.ops import (merge_compact,
                                                  merge_compact_plain,
                                                  merge_compact_sharded)

N, C = 64, 8
MODES = ("all", "none", "few", "half", "empty", "full", "zeros")


def case(seed, K, mode, bc, junk=True, n=N, c=C, b_at=None):
    """Seeded inputs shaped as a map pass makes them (see module doc);
    ``b_at`` ``"before"`` / ``"after"`` gives the B run the smallest /
    largest keys."""
    rng = np.random.default_rng(seed)
    ak = np.full((K, n), np.inf, np.float32)
    av = np.full((K, n), np.inf, np.float32)
    keep = np.zeros((K, n), np.int32)
    bk = np.full((K, c), np.inf, np.float32)
    bv = np.full((K, c), np.inf, np.float32)
    bcount = np.zeros(K, np.int32)
    idx = np.arange(n)
    for k in range(K):
        b = min(bc, c)
        s = 0 if mode == "empty" else n if mode == "full" else \
            int(rng.integers(max(n // 2 - b, 0), n - b + 1))
        pool = rng.choice(4 * (n + c), s + b, replace=False) - 2 * (n + c)
        if mode == "zeros" and not (pool == 0).any():
            pool[0] = 0
        keys = pool.astype(np.float32)
        if b_at is not None:
            keys = np.sort(keys)
            if b_at == "before":
                keys = np.roll(keys, -b)
        if mode == "zeros":                     # raw -0.0 / flushed tiny
            keys[keys == 0] = np.float32(-0.0) if k % 2 == 0 else 0.0
        a = np.sort(keys[:s], kind="stable")
        run = np.sort(keys[s:])
        vals = rng.uniform(-10, 10, s + b).astype(np.float32)
        ak[k, :s], av[k, :s] = a, vals[:s]
        kp = idx < s
        if mode in ("none", "empty"):
            kp[:] = False
        elif mode in ("few", "zeros", "full"):
            drop = b if mode == "full" else min(4, s)
            kp[rng.choice(s, drop, replace=False)] = False
        elif mode == "half":
            kp &= rng.random(n) < 0.5
        keep[k] = kp
        bk[k, :b], bv[k, :b], bcount[k] = run, vals[s:], b
        if junk:
            dead = np.flatnonzero(~kp)
            pick = rng.integers(0, 4, dead.size)
            ak[k, dead] = np.select(
                [pick == 0, pick == 1, pick == 2],
                [np.float32(np.inf), np.float32(-np.inf), np.float32(np.nan)],
                rng.uniform(-1e6, 1e6, dead.size).astype(np.float32))
            av[k, dead] = rng.uniform(-1e6, 1e6, dead.size)
            bk[k, b:] = rng.uniform(-1e6, 1e6, c - b)
    return ak, av, keep, bk, bv, bcount


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _plain(inputs):
    mk, mv = merge_compact_plain(*(_t(x) for x in inputs))
    return mk.numpy(), mv.numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bc", [0, 1, C])
def test_plain_equals_numpy_oracles(mode, bc):
    inputs = case(10 * MODES.index(mode) + bc, 4, mode, bc)
    mk, mv = _plain(inputs)
    for k in range(4):
        for oracle in (merge_compact_reference, tref.merge_compact_reference):
            rk, rv = oracle(*(x[k] for x in inputs))
            np.testing.assert_array_equal(_bits(mk[k]), _bits(rk))
            np.testing.assert_array_equal(_bits(mv[k]), _bits(rv))
    if mode == "full":
        assert np.all(np.isfinite(mk))           # merged length == N


@pytest.mark.parametrize("K", [1, 2, 4])
def test_plain_equals_xla_twin_every_mode(K):
    twin = jax.jit(jax.vmap(jops.merge_compact_xla))
    for i, mode in enumerate(MODES):
        for bc in (0, 1, 5, C):
            inputs = case(100 * K + 10 * i + bc, K, mode, bc, junk=i % 2 == 0)
            mk, mv = _plain(inputs)
            xk, xv = twin(*(jnp.asarray(x) for x in inputs))
            np.testing.assert_array_equal(_bits(mk), _bits(xk),
                                          err_msg=f"{mode} {bc}")
            np.testing.assert_array_equal(_bits(mv), _bits(xv),
                                          err_msg=f"{mode} {bc}")


@pytest.mark.parametrize("K", [1, 2, 4])
def test_plain_equals_pallas_kernel_in_interpret_mode(K):
    # the reference's Pallas kernel needs a B run of at least one lane
    for i, (mode, bc) in enumerate([("few", C), ("half", 1), ("empty", C),
                                    ("full", C), ("zeros", 3),
                                    ("all", 0)]):
        inputs = case(200 * K + i, K, mode, bc, n=300)
        mk, mv = _plain(inputs)
        pk, pv = jops.merge_compact_sharded(
            *(jnp.asarray(x) for x in inputs), interpret=True)
        np.testing.assert_array_equal(_bits(mk), _bits(pk), err_msg=mode)
        np.testing.assert_array_equal(_bits(mv), _bits(pv), err_msg=mode)


def test_cpu_wrapper_runs_plain_writes_out_rows_and_never_launches():
    inputs = case(7, 4, "few", C)
    want_k, want_v = _plain(inputs)
    before = merge_compact_sharded.launches
    # the pass's form: write into the bodies of a fresh (K, N + 1) block
    block = torch.full((2, 4, N + 1), -7.0)
    got = merge_compact_sharded(*(_t(x) for x in inputs[:2]),
                                _t(inputs[2]).bool(),
                                *(_t(x) for x in inputs[3:]),
                                out=(block[0, :, :N], block[1, :, :N]))
    assert got[0].data_ptr() == block[0].data_ptr()
    np.testing.assert_array_equal(_bits(block[0, :, :N]), _bits(want_k))
    np.testing.assert_array_equal(_bits(block[1, :, :N]), _bits(want_v))
    assert torch.all(block[:, :, N] == -7.0)        # the scratch column
    # the K = 1 call
    mk, mv = merge_compact(*(_t(x[1]) for x in inputs[:5]),
                           int(inputs[5][1]))
    np.testing.assert_array_equal(_bits(mk), _bits(want_k[1]))
    np.testing.assert_array_equal(_bits(mv), _bits(want_v[1]))
    assert merge_compact_sharded.launches == before
    assert sorted_merge.merge_compact_sharded is merge_compact_sharded


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _strided(t, cuda):
    """``t`` as the body of a (K, N + 1) block on the card: rows k >= 1
    start unaligned, as the map's state rows do."""
    K, n = t.shape
    blk = torch.full((K, n + 1), -7.0, dtype=t.dtype, device=cuda)
    blk[:, :n] = t.to(cuda)
    return blk[:, :n]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [N, 1000, "tile-1", "tile", "tile+1", 20_000])
def test_cuda_kernel_equals_plain_version(cuda, n):
    """Every mode at b_count 0, 1 and C, the B run below or above all of
    A, on contiguous and on unaligned strided rows, N one either side of
    the kernel's tile; two calls in a row reuse the stream's status words
    (their epochs differ)."""
    if isinstance(n, str):
        tile = sorted_merge.ops._kernel_limits()[0]
        n = tile + {"tile-1": -1, "tile": 0, "tile+1": 1}[n]
    for i, mode in enumerate(MODES):
        for bc in (0, 1, C):
            for b_at in (None, "before", "after"):
                inputs = case(300 + i * 7 + bc, 4, mode, bc, n=n, b_at=b_at)
                t = [_t(x).to(cuda) for x in inputs]
                t[2] = t[2].bool()
                before = merge_compact_sharded.launches
                got = merge_compact_sharded(*t)
                want = merge_compact_plain(*t)
                assert merge_compact_sharded.launches == before + 1
                for g, w in zip(got, want):
                    assert torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
                if b_at is None:
                    rows = [_strided(x, cuda) for x in t[:2]]
                    out = (_strided(torch.zeros_like(t[0]), cuda),
                           _strided(torch.zeros_like(t[0]), cuda))
                    merge_compact_sharded(*rows, *t[2:], out=out)
                    for g, w in zip(out, want):
                        assert torch.equal(g.view(torch.int32),
                                           w.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,bc,b_at", [("few", 1024, None),
                                          ("half", 512, None),
                                          ("all", 1024, "before"),
                                          ("none", 1024, None)])
def test_cuda_kernel_equals_plain_version_at_1024_lanes(cuda, mode, bc,
                                                        b_at):
    inputs = case(400 + bc, 2, mode, bc, n=5000, c=1024, b_at=b_at)
    t = [_t(x).to(cuda) for x in inputs]
    t[2] = t[2].bool()
    got = merge_compact_sharded(*t)
    want = merge_compact_plain(*t)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
