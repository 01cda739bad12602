#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA device and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use).  Phases,
each printing a line:

1. ``device`` — the card's name, then ``nvidia-smi``'s name and power limit.
2. ``build`` — the four kernels compiled for ``sm_90a`` (time, ptxas report).
3. ``kernels`` — ``heap_kmin``, ``heap_sift`` and ``heap_insert`` run on
   CUDA tensors at the main path's shapes (4,000,000 keys; K = 1 and
   K = 4 shards; c_max = 16) over seeded random heaps and batches — empty
   heaps, ``ne > size``, ``m = 0`` shards, chunks crossing a level
   boundary, duplicate keys — each result held element-wise (exactly:
   keys are only compared and moved) against the kernel's plain PyTorch
   version on the same inputs; then per-launch times from CUDA events
   around 30 back-to-back launches (median of 5 such windows), the plain
   version's time, the bound, and for ``heap_kmin`` the ``torch.topk``
   yardstick.
4. ``pq-single`` — ``pc_priority_queue(BatchedPriorityQueue(...))`` and
5. ``pq-sharded`` — ``pc_sharded_priority_queue(..., n_shards=4)``: 8
   client threads of 50/50 insert/extract_min over 4,000,000 initial keys,
   with the kernel launch counts of that run, conservation of the
   multiset, the heap property of every shard, and a seeded single-thread
   replay of 240 combined batches through the kernel pass and the plain
   pass (both on the card, bit-equal after every batch) against
   ``SequentialHeap``.
6. ``label_prop`` kernel checks — seeded graphs at 1,000,000 vertices
   (the graph's half-populated tree edge buffer with junk in its invalid
   slots, (0,0) padding + self-loops + duplicate edges, isolated
   vertices, an empty edge set, a chain of n vertices, a forest, the
   on-device gates, the contracted-merge form and the union-find form):
   every step of every fixpoint with ``max_iters = 1`` and every whole
   fixpoint held element-wise (exactly) against the plain version; then
   the per-launch times of one step and one full rebuild at the graph's
   shape, the plain version's and the bound.
7. ``graph`` — ``batched_read_optimized(DeviceGraph(...))`` (bench_graph's
   ``PC-K4`` row): 1,000,000 vertices, one random tree with half its
   999,999 edges prepopulated, 8 client threads of 90% ``connected`` and
   5% each insert/delete of a tree edge; the kernel launch count, full
   rebuilds and fast merges of that run, per-edge-class conservation,
   final labels against the union-find oracle, and a seeded replay of
   combined update+read batches through the kernel pass and the plain
   pass (every state field bit-equal after each batch, answers equal to
   the port's ``DynamicGraph``), with a check that a read pass makes ONE
   blocking device-to-host transfer (any other sync raises under
   ``torch.cuda.set_sync_debug_mode("error")``).
8. ``unionfind`` — ``pc_union_find(BatchedUnionFind(1,000,000, c_max=16))``:
   8 threads of bench_unionfind's mix at 90% reads; launch count, final
   labels against the oracle of every union, and a replay through the
   kernel pass and the plain pass against ``SequentialUnionFind``.

Then one JSON line with every kernel's numbers and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises (non-zero
exit); without a CUDA device, or without the repository's ``src/``, the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
C_MAX = 16                     # bench_pq.C_MAX (and bench_graph's)
N_KEYS = 4_000_000             # initial keys of the pq phases
THREADS = 8
OPS_PER_THREAD = 1000          # pq phases (depth cut to fit the graph)
REPLAY_BATCHES = 240
GRAPH_VERTICES = 1_000_000     # graph, unionfind and label_prop checks
GRAPH_OPS = 1000               # per thread, graph and unionfind phases
READ_PCT = 90                  # bench_graph / bench_unionfind c = 90
GRAPH_REPLAY = 200
UF_REPLAY = 120
KEY_RANGE = 2 ** 31 - 1
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
REPLACES = {
    "heap_kmin": "src/repro/kernels/heap_kmin/kernel.py:86",
    "heap_sift": "src/repro/kernels/heap_sift/kernel.py:115",
    "heap_insert": "src/repro/kernels/heap_insert/kernel.py:170",
    "label_prop": "src/repro/kernels/label_prop/kernel.py:112",
}
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}


def shard_capacity(n_keys: int, n_shards: int, c_max: int = C_MAX,
                   z: float = 6.0) -> int:
    """Per-shard capacity that survives hash-routing skew w.h.p. (a copy
    of ``benchmarks/bench_pq.py``'s rule: mean + z·σ of a binomial
    occupancy, plus one batch and the scratch slot)."""
    n = max(int(n_keys), 1)
    p = 1.0 / n_shards
    sigma = math.sqrt(n * p * (1.0 - p))
    return int(math.ceil(n * p + z * sigma)) + c_max + 2


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# kernels: every launch held against the plain version on cloned inputs
# ---------------------------------------------------------------------------
class CheckedPhases:
    """A pass's three phases, each run by the kernel wrapper AND by the
    plain version on clones of the same inputs, compared element-wise
    (any difference raises).  The last inputs of each kernel are kept for
    timing."""

    def __init__(self):
        self.calls = {"heap_kmin": 0, "heap_sift": 0, "heap_insert": 0}
        self.max_abs_err = dict.fromkeys(self.calls, 0.0)
        self.inputs = {}

    def _diff(self, kernel, what, got, want):
        """Record the largest |kernel - plain| over the outputs checked so
        far (+inf equal to +inf counts 0), and raise unless equal."""
        import torch

        name = f"{kernel} {what}"
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name}: shape/dtype {got.shape}/{got.dtype} vs "
              f"{want.shape}/{want.dtype}")
        g, w = got.double(), want.double()
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        err = torch.where(same, 0.0, (g - w).abs())
        err = float(torch.nan_to_num(err, nan=math.inf).max()) \
            if err.numel() else 0.0
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name}: kernel != plain, max_abs_err {err}, "
                f"{int((got != want).sum())} elements differ")

    def kmin(self, a, size, ne, *, c_max):
        from repro_torch.kernels import heap_kmin

        self.inputs["heap_kmin"] = (a.clone(), size.clone(), ne, c_max)
        ids, vals = heap_kmin.k_smallest_sharded(a, size, ne, c_max=c_max)
        pids, pvals = heap_kmin.k_smallest_plain(a, size, ne, c_max)
        self._diff("heap_kmin", "ids", ids, pids)
        self._diff("heap_kmin", "vals", vals, pvals)
        self.calls["heap_kmin"] += 1
        return ids, vals

    def sift(self, a, size, starts, active):
        from repro_torch.kernels import heap_sift

        self.inputs["heap_sift"] = (a.clone(), size.clone(), starts.clone(),
                                    active.clone())
        ap = a.clone()
        heap_sift.sift_wavefront_sharded(a, size, starts, active)
        heap_sift.sift_wavefront_plain(ap, size, starts, active)
        self._diff("heap_sift", "heap", a, ap)
        self.calls["heap_sift"] += 1
        return a

    def phase4(self, a, size, rem, m_left):
        from repro_torch.kernels import heap_insert

        self.inputs["heap_insert"] = (a.clone(), size.clone(), rem.clone(),
                                      m_left.clone())
        ap = a.clone()
        _, new_size = heap_insert.phase4_sharded(a, size, rem, m_left)
        _, psize = heap_insert.phase4_plain(ap, size, rem, m_left)
        self._diff("heap_insert", "heap", a, ap)
        self._diff("heap_insert", "size", new_size, psize.to(new_size.dtype))
        self.calls["heap_insert"] += 1
        return a, new_size


def random_heap_stack(torch, K, cap, sizes, gen, dup, dev):
    """A valid random heap per shard: a[v] = a[v // 2] + increment, level by
    level (duplicates when the increments are coarse), +inf past size."""
    a = torch.empty((K, cap), dtype=torch.float32, device=dev)
    a[:, 0] = math.inf
    a[:, 1] = torch.floor(torch.rand(K, generator=gen, device=dev) * 1e6)
    lo = 2
    while lo < cap:
        hi = min(2 * lo, cap)
        inc = torch.rand((K, hi - lo), generator=gen, device=dev) * 1e5
        inc = torch.floor(inc / 5e4) * 5e4 if dup else torch.floor(inc)
        par = torch.arange(lo, hi, device=dev) // 2
        a[:, lo:hi] = a[:, par] + inc
        lo = hi
    idx = torch.arange(cap, device=dev)
    size_t = torch.tensor(sizes, dtype=torch.int32, device=dev)
    a[idx[None, :] > size_t[:, None]] = math.inf
    a[:, 0] = math.inf
    return a, size_t


def pick_sizes(rng, K, cap, c_max):
    top = cap - 1 - c_max
    out = []
    for _ in range(K):
        kind = int(rng.integers(5))
        if kind == 0:
            out.append(0)                                  # empty heap
        elif kind == 1:
            out.append(int(rng.integers(1, c_max)))        # ne > size
        elif kind == 2:                                    # level boundary
            d = int(rng.integers(2, int(math.log2(top))))
            out.append(max((1 << d) - 1 - int(rng.integers(0, c_max)), 0))
        else:
            out.append(int(rng.integers(top // 2, top)))
    return out


def kernel_phase(torch, dev, seed, caps, n_cases):
    """Random heaps and batches through checked passes, K = 1 and K = 4."""
    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq

    checked = CheckedPhases()
    phases = bpq.Phases(checked.kmin, checked.sift, checked.phase4)
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for K, cap in caps:
        for case in range(n_cases):
            sizes = pick_sizes(rng, K, cap, C_MAX)
            a, size = random_heap_stack(torch, K, cap, sizes, gen,
                                        dup=case % 2 == 1, dev=dev)
            kind = case % 4       # extract-only, insert-only, mixed, full
            ne = 0 if kind == 1 else int(rng.integers(1, C_MAX + 1))
            ni = 0 if kind == 0 else int(rng.integers(1, C_MAX + 1))
            if kind == 3:
                ne = ni = C_MAX
            buf = np.full(C_MAX, np.inf, np.float32)
            root = float(a[:, 1].min()) if max(sizes) else 0.0
            fresh = rng.uniform(0, 2e6, ni).astype(np.float32)
            dups = np.float32(root if math.isfinite(root) else 0.0)
            buf[:ni] = np.where(rng.random(ni) < 0.3, dups, np.floor(fresh))
            vals = torch.tensor(buf, device=dev)
            if K == 1:
                st = bpq.HeapState(a[0], size[0])
                bpq.apply_batch_impl(st, ne, vals, ni, c_max=C_MAX,
                                     phases=phases)
            else:
                st = spq.ShardedHeapState(a, size)
                spq._sharded_apply_batch(st, ne, vals, ni, c_max=C_MAX,
                                         n_shards=K, phases=phases)
    # dedicated batches at the K = 4 shape for timing: extract-only keeps
    # heap_kmin and heap_sift inputs, insert-only the heap_insert inputs
    K, cap = caps[-1]
    sizes = [cap - 1 - C_MAX - int(rng.integers(0, 1000)) for _ in range(K)]
    a, size = random_heap_stack(torch, K, cap, sizes, gen, dup=False,
                                dev=dev)
    st = spq.ShardedHeapState(a, size)
    spq._sharded_apply_batch(st, C_MAX, torch.full((C_MAX,), math.inf,
                                                   device=dev), 0,
                             c_max=C_MAX, n_shards=K, phases=phases)
    timed = {"heap_kmin": checked.inputs["heap_kmin"],
             "heap_sift": checked.inputs["heap_sift"]}
    ins = torch.tensor(np.floor(rng.uniform(0, 2e6, C_MAX)),
                       dtype=torch.float32, device=dev)
    spq._sharded_apply_batch(st, 0, ins, C_MAX, c_max=C_MAX, n_shards=K,
                             phases=phases)
    timed["heap_insert"] = checked.inputs["heap_insert"]
    for name, n in checked.calls.items():
        check(n > 0, f"{name}: never checked")
    return checked, timed


RING = 30                 # launches per timed window, one heap copy each
PLAIN_RING = 10           # the plain versions take milliseconds per call
WINDOWS = 5
HOLD_CYCLES = 100_000_000  # torch.cuda._sleep: ~50 ms at the H100's clock


def _per_launch_ms(torch, fn, ring, a_in, hold, windows=WINDOWS):
    """Median over ``windows`` of one CUDA-event window around
    ``len(ring)`` back-to-back calls ``fn(ring[i])``, divided by the count.
    Every call gets its own copy of the heap ``a_in`` (restored before the
    window, outside it), so no in-place call sees its predecessor's output.
    With ``hold``, a spin kernel keeps the stream busy while the host
    enqueues the calls, so the window holds the device's time and no host
    gaps; a window that the device caught up with raises.  Without it (the
    plain versions, which synchronise inside, and ``torch.topk``, which
    may) the window is their wall time."""
    times = []
    for w in range(windows + 1):              # window 0 warms up
        for r in ring:
            r.copy_(a_in)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        t0.record()
        for r in ring:
            fn(r)
        caught_up = hold and t0.query()
        t1.record()
        t1.synchronize()
        if w:
            check(not caught_up, "timing: the device caught up with the "
                                 "host inside a held window")
            times.append(t0.elapsed_time(t1) / len(ring))
    return float(np.median(times))


def time_kernels(torch, timed):
    """Per-launch times (CUDA events over back-to-back launches, see
    :func:`_per_launch_ms`) of each kernel, its plain version and, for
    heap_kmin, torch.topk — on the kept K = 4 inputs; the bound from the
    bytes and operations these inputs need."""
    from repro_torch.kernels import heap_insert, heap_kmin, heap_sift

    def rings(a_in):
        return ([torch.empty_like(a_in) for _ in range(RING)],
                [torch.empty_like(a_in) for _ in range(PLAIN_RING)])

    out = {}
    a_in, size, ne, c_max = timed["heap_kmin"]
    ids, _ = heap_kmin.k_smallest_sharded(a_in, size, ne, c_max=c_max)
    K = a_in.shape[0]
    steps = int((ids > 0).sum())
    ring, plain_ring = rings(a_in)
    out["heap_kmin"] = dict(
        ms=_per_launch_ms(torch, lambda a: heap_kmin.k_smallest_sharded(
            a, size, ne, c_max=c_max), ring, a_in, hold=True),
        plain_ms=_per_launch_ms(torch, lambda a: heap_kmin.k_smallest_plain(
            a, size, ne, c_max), plain_ring, a_in, hold=False),
        library_ms=_per_launch_ms(torch, lambda a: torch.topk(
            a, ne, dim=1, largest=False), ring, a_in, hold=False),
        bytes=4 * (K + 2 * steps) + 4 * K + 8 * K * c_max,
        ops=steps * (2 * c_max + 1))

    a_in, size, starts, active = timed["heap_sift"]
    a = a_in.clone()
    heap_sift.sift_wavefront_sharded(a, size, starts, active)
    changed = int((a != a_in).sum())
    c = starts.shape[1]
    ring, plain_ring = rings(a_in)
    out["heap_sift"] = dict(
        ms=_per_launch_ms(torch, lambda a: heap_sift.sift_wavefront_sharded(
            a, size, starts, active), ring, a_in, hold=True),
        plain_ms=_per_launch_ms(torch, lambda a: heap_sift.sift_wavefront_plain(
            a, size, starts, active), plain_ring, a_in, hold=False),
        library_ms=None,
        bytes=8 * changed + 4 * K + 5 * K * c, ops=3 * changed)

    a_in, size, rem, m_left = timed["heap_insert"]
    a = a_in.clone()
    heap_insert.phase4_sharded(a, size, rem, m_left)
    changed = int((a != a_in).sum())
    C = rem.shape[1]
    levels = int(math.log2(a.shape[1])) + 1
    ring, plain_ring = rings(a_in)
    out["heap_insert"] = dict(
        ms=_per_launch_ms(torch, lambda a: heap_insert.phase4_sharded(
            a, size, rem, m_left), ring, a_in, hold=True),
        plain_ms=_per_launch_ms(torch, lambda a: heap_insert.phase4_plain(
            a, size, rem, m_left), plain_ring, a_in, hold=False),
        library_ms=None,
        bytes=8 * changed + 4 * K * C + 12 * K,
        ops=int(m_left.sum()) * levels * C)
    del ring, plain_ring
    for r in out.values():
        byte_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = r["ops"] / F32_OPS_PER_S * 1e3
        r["bound_ms"] = max(byte_ms, op_ms)
        r["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    return out


# ---------------------------------------------------------------------------
# the main path: the concurrent PQ under 8 client threads, then a replay
# ---------------------------------------------------------------------------
def drive(engine, threads, ops, seed):
    """``threads`` clients, each a 50/50 insert/extract_min stream."""
    inserted = [[] for _ in range(threads)]
    extracted = [[] for _ in range(threads)]
    errors = []

    def client(tid):
        try:
            r = np.random.default_rng([seed, 2, tid])
            vals = r.uniform(0, KEY_RANGE, ops).astype(np.float32)
            for i in range(ops):
                if r.integers(2) == 0:
                    engine.execute("insert", float(vals[i]))
                    inserted[tid].append(vals[i])
                else:
                    extracted[tid].append(engine.execute("extract_min"))
        except BaseException as exc:       # re-raised on the main thread
            errors.append(exc)

    ts = [threading.Thread(target=client, args=(t,), daemon=True)
          for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    check(not any(t.is_alive() for t in ts), "client threads hung")
    if errors:
        raise errors[0]
    ins = np.array([v for lst in inserted for v in lst], np.float32)
    ext = [v for lst in extracted for v in lst]
    return ins, ext, seconds


def replay(torch, pq, pass_fn, plain_phases, n_batches, seed):
    """Seeded single-thread batches through the kernel pass and the plain
    pass on clones of the queue's state, bit-equal after every batch, and
    answers equal to SequentialHeap's."""
    from repro_torch.core.seq_pq import SequentialHeap

    rng = np.random.default_rng([seed, 3])
    st_k = type(pq.state)(pq.state.a.clone(), pq.state.size.clone())
    st_p = type(pq.state)(pq.state.a.clone(), pq.state.size.clone())
    oracle = SequentialHeap()
    oracle.a = [float("-inf")] + pq.values()
    dev = pq.state.a.device
    for b in range(n_batches):
        w = int(rng.integers(1, C_MAX + 1))
        kind = b % 3            # extract-heavy, insert-heavy, mixed
        ne = w if kind == 0 else (int(rng.integers(0, w // 4 + 1))
                                  if kind == 1 else int(rng.integers(0, w + 1)))
        ni = w if kind == 1 else (int(rng.integers(0, w // 4 + 1))
                                  if kind == 0 else int(rng.integers(0, w + 1)))
        head = oracle.a[1] if oracle.size else 0.0
        fresh = rng.uniform(0, KEY_RANGE, ni).astype(np.float32)
        ins = np.where(rng.random(ni) < 0.25, np.float32(head), fresh)
        buf = np.full(C_MAX, np.inf, np.float32)
        buf[:ni] = ins
        vals = torch.tensor(buf, device=dev)
        _, out_k, _ = pass_fn(st_k, ne, vals, ni)
        _, out_p, _ = pass_fn(st_p, ne, vals, ni, phases=plain_phases)
        check(torch.equal(st_k.a, st_p.a) and torch.equal(st_k.size,
                                                          st_p.size)
              and torch.equal(out_k, out_p),
              f"replay batch {b}: kernel pass != plain pass")
        want = [oracle.extract_min() for _ in range(ne)]
        for v in ins:
            oracle.insert(float(v))
        got = out_k[:ne].cpu().numpy().tolist()
        got = [g if math.isfinite(g) else None for g in got]
        check(got == want, f"replay batch {b}: {got} != oracle {want}")
    check(sorted(oracle.a[1:]) == sorted(
        _values(st_k.a.cpu().numpy(), st_k.size.cpu().numpy())),
        "replay: final multiset differs from the oracle")
    return n_batches


def _values(a, sizes):
    a = a.reshape(-1, a.shape[-1])
    sizes = np.asarray(sizes).reshape(-1)
    return [v for k in range(a.shape[0])
            for v in a[k, 1:int(sizes[k]) + 1].tolist()]


def counted(torch, dev, name, counters, expect, fn):
    """Run ``fn()`` with every kernel's launch count set to 0 just before
    and read just after; on the card, each kernel in ``expect`` must have
    launched.  Returns ``(fn's result, counts)``."""
    for f in counters.values():
        f.launches = 0
    got = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    if dev.type == "cuda":
        for k in expect:
            check(launches[k] > 0, f"{name}: kernel {k} was never launched "
                                   f"on the main path")
    return got, launches


def pq_phase(torch, name, engine, init, counters, seed, threads, ops,
             n_replay, pass_fn, plain_phases):
    from repro_torch.core.batched_pq import check_heap_property

    pq = engine.pq
    (ins, ext, seconds), launches = counted(
        torch, pq.state.a.device, name, counters,
        ("heap_kmin", "heap_sift", "heap_insert"),
        lambda: drive(engine, threads, ops, seed))
    # conservation: initial ∪ inserted == extracted ∪ remaining
    check(all(v is not None for v in ext), f"{name}: empty-queue extract")
    remaining = np.array(pq.values(), np.float32)
    lhs = np.sort(np.concatenate([init, ins]))
    rhs = np.sort(np.concatenate([np.array(ext, np.float32), remaining]))
    check(np.array_equal(lhs, rhs), f"{name}: multiset not conserved")
    a = pq.state.a.cpu().numpy().reshape(-1, pq.state.a.shape[-1])
    sizes = pq.state.size.cpu().numpy().reshape(-1)
    for k in range(a.shape[0]):
        check(np.isinf(a[k, 0]), f"{name}: shard {k} scratch slot not +inf")
        check(check_heap_property(a[k], int(sizes[k])),
              f"{name}: shard {k} violates the heap property")
    n_ops = threads * ops
    stats = {
        "ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
        "passes": engine.passes,
        "mean_batch": float(np.mean(engine.combined_sizes)),
        "eliminated": engine.eliminated,
        "launches": launches,
        "heap_bytes": pq.state.a.numel() * 4 + pq.state.size.numel() * 4,
    }
    stats["replayed"] = replay(torch, pq, pass_fn, plain_phases, n_replay,
                               seed)
    return stats


# ---------------------------------------------------------------------------
# label_prop: every launch held against the plain version
# ---------------------------------------------------------------------------
def random_tree(rng, n):
    """Random spanning tree on [0, n) as endpoint arrays: vertex perm[i]
    hangs from a uniform earlier vertex (bench_graph's ``_random_tree``,
    vectorized)."""
    perm = rng.permutation(n).astype(np.int32)
    parent = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    return perm[1:], perm[parent]


class LabelPropCheck:
    """Runs ``propagate`` (the kernel on CUDA tensors) and
    ``propagate_plain`` on clones of the same output buffer and compares
    the labels element-wise and the step counts; any difference raises."""

    def __init__(self):
        self.calls = 0
        self.max_abs_err = 0.0

    def __call__(self, eu, ev, out, **kw):
        import torch

        from repro_torch.kernels.label_prop import propagate, propagate_plain

        got, want = out.clone(), out.clone()
        it_k = int(propagate(eu, ev, got, **kw))
        it_p = int(propagate_plain(eu, ev, want, **kw))
        err = float((got.long() - want.long()).abs().max()) \
            if got.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        self.calls += 1
        if not torch.equal(got, want) or it_k != it_p:
            raise AssertionError(
                f"label_prop: kernel != plain ({sorted(kw)}): max_abs_err "
                f"{err}, steps {it_k} vs {it_p}")
        return got, it_k


def label_prop_cases(torch, dev, seed, n):
    """The checked graphs: ``(name, eu, ev, kw)`` on the card, ``kw`` the
    edge options of ``propagate`` (the valid mask)."""
    rng = np.random.default_rng([seed, 7])

    def t(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype=dt)

    tu, tv = random_tree(rng, n)
    cases = []
    # the graph's edge buffer: half the tree at random slots, junk vertex
    # ids in the invalid slots (valid masks them), the scratch slot last
    cap = (n - 1) + 2 * C_MAX
    eu = rng.integers(0, n, cap + 1).astype(np.int32)
    ev = rng.integers(0, n, cap + 1).astype(np.int32)
    valid = np.zeros(cap + 1, bool)
    keep = np.flatnonzero(rng.random(n - 1) < 0.5)
    slots = rng.choice(cap, keep.size, replace=False)
    eu[slots], ev[slots], valid[slots] = tu[keep], tv[keep], True
    cases.append(("tree buffer", t(eu), t(ev),
                  dict(valid=t(valid, torch.bool))))
    # (0,0) padding, self-loops and duplicate edges
    E = n // 2
    pu, pv = rng.integers(0, n, E), rng.integers(0, n, E)
    pad = rng.random(E) < 0.2
    pu[pad] = pv[pad] = 0
    loop = rng.random(E) < 0.1
    pv[loop] = pu[loop]
    dup = rng.integers(0, E, E // 10)
    pu[-dup.size:], pv[-dup.size:] = pu[dup], pv[dup]
    cases.append(("padding+loops+dups", t(pu), t(pv), {}))
    # isolated vertices: edges among the first n // 8 only
    m = n // 8
    cases.append(("isolated", t(rng.integers(0, m, m)),
                  t(rng.integers(0, m, m)), {}))
    cases.append(("empty", t(np.zeros(0, np.int32)),
                  t(np.zeros(0, np.int32)), {}))
    # a chain of n vertices, edges in shuffled order
    order = rng.permutation(n - 1)
    cases.append(("chain", t(order), t(order + 1), {}))
    # a forest: a random tree with a tenth of its edges dropped
    fu, fv = random_tree(rng, n)
    keep = rng.random(n - 1) < 0.9
    cases.append(("forest", t(fu[keep]), t(fv[keep]), {}))
    return cases


def label_prop_phase(torch, dev, seed, n):
    """Every case step by step (``max_iters = 1`` from each iterate, each
    held against the plain step) and as one whole fixpoint; then the
    device gates, the contracted-merge form and the union-find form.
    Returns the check record, the inputs kept for timing and the steps of
    each case's fixpoint."""
    from repro_torch.kernels.label_prop import propagate_plain

    chk = LabelPropCheck()
    rng = np.random.default_rng([seed, 8])
    yes = torch.ones((), dtype=torch.bool, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    ident = torch.arange(n, dtype=torch.int32, device=dev)
    timed = {}
    steps = {}
    for name, eu, ev, kw in label_prop_cases(torch, dev, seed, n):
        l = ident.clone()
        while True:                          # every step of the fixpoint
            l2, _ = chk(eu, ev, torch.empty_like(l), init=l, max_iters=1,
                        **kw)
            if torch.equal(l2, l):
                break
            l = l2
        fixed, iters = chk(eu, ev, torch.empty_like(l), **kw)
        check(torch.equal(fixed, l), f"label_prop {name}: the fixpoint "
                                     f"differs from its steps")
        steps[name] = iters
        if name == "tree buffer":
            timed = dict(eu=eu, ev=ev, valid=kw["valid"], labels=fixed,
                         iters=iters)
            # the read pass's gates: when / unless decide on the device
            chk(eu, ev, ident.clone(), when=yes, **kw)
            chk(eu, ev, ident.clone(), when=no, **kw)
            chk(eu, ev, ident.clone(), unless=yes, **kw)
    # the contracted-merge form: pending inserts of other tree edges into
    # the tree buffer's labels, the live lanes counted on the device
    eu, ev, valid, base = (timed[k] for k in ("eu", "ev", "valid",
                                              "labels"))
    width = 2 * C_MAX + 1
    tu, tv = random_tree(np.random.default_rng([seed, 7]), n)
    for k in (1, 5, 2 * C_MAX, 0):
        pick = rng.integers(0, n - 1, width)
        pend = np.stack([rng.integers(0, n, width),
                         rng.integers(0, n, width)]).astype(np.int32)
        pend[0, :k], pend[1, :k] = tu[pick[:k]], tv[pick[:k]]
        pend = torch.from_numpy(pend).to(dev)
        live = torch.full((), k, dtype=torch.int32, device=dev)
        merged, _ = chk(pend[0], pend[1], base.clone(), e_live=live,
                        relabel=True, unless=no)
        if not k:
            continue
        timed["merge"] = dict(pu=pend[0], pv=pend[1], live=live,
                              labels=base)
        for m_it in (1, 2):                  # steps of the contracted graph
            chk(pend[0], pend[1], base.clone(), e_live=live, relabel=True,
                max_iters=m_it)
        full = torch.empty_like(base)
        propagate_plain(torch.cat([eu[valid], pend[0, :k]]),
                        torch.cat([ev[valid], pend[1, :k]]), full)
        check(torch.equal(merged, full),
              "label_prop: the merge form != the full rebuild")
    # the union-find form: ≤ c_max unions (chain and random) on a labeling
    uf = base.clone()
    for _ in range(4):
        u = rng.integers(0, n, C_MAX)
        v = np.where(rng.random(C_MAX) < 0.5, (u + 1) % n,
                     rng.integers(0, n, C_MAX))
        uf, _ = chk(torch.from_numpy(u.astype(np.int32)).to(dev),
                    torch.from_numpy(v.astype(np.int32)).to(dev), uf,
                    relabel=True)
    check(chk.calls >= 50, f"label_prop: only {chk.calls} checked launches")
    return chk, timed, steps


def time_label_prop(torch, timed):
    """Per-launch times (``_per_launch_ms``) at the graph's full-rebuild
    shape: the whole fixpoint (``ms``), one step from the identity, and
    the contracted merge of a pending batch; the plain versions beside
    them.  The bound counts each input once and each output once (the
    fixpoint: eu, ev, valid in, labels out; a step: its labels in as
    well) over 3.35 TB/s, against a min and a compare per edge endpoint
    and per vertex per step over 67 TOP/s."""
    from repro_torch.kernels.label_prop import propagate, propagate_plain

    eu, ev, valid, iters = (timed[k] for k in ("eu", "ev", "valid",
                                               "iters"))
    n, E = timed["labels"].numel(), eu.numel()
    ident = torch.arange(n, dtype=torch.int32, device=eu.device)
    yes = torch.ones((), dtype=torch.bool, device=eu.device)
    no = torch.zeros((), dtype=torch.bool, device=eu.device)
    ring = [torch.empty_like(ident) for _ in range(RING)]
    plain_ring = ring[:PLAIN_RING]
    m = timed["merge"]
    out = {
        "ms": _per_launch_ms(torch, lambda r: propagate(
            eu, ev, r, valid=valid, when=yes), ring, ident, hold=True),
        "plain_ms": _per_launch_ms(torch, lambda r: propagate_plain(
            eu, ev, r, valid=valid, when=yes), plain_ring, ident,
            hold=False),
        "step_ms": _per_launch_ms(torch, lambda r: propagate(
            eu, ev, r, init=ident, valid=valid, max_iters=1), ring, ident,
            hold=True),
        "step_plain_ms": _per_launch_ms(torch, lambda r: propagate_plain(
            eu, ev, r, init=ident, valid=valid, max_iters=1), plain_ring,
            ident, hold=False),
        "merge_ms": _per_launch_ms(torch, lambda r: propagate(
            m["pu"], m["pv"], r, e_live=m["live"], relabel=True,
            unless=no), ring, m["labels"], hold=True),
        "fixpoint_steps": iters, "n": n, "edge_slots": E,
        "live_edges": int(valid.sum()), "library_ms": None,
    }
    byte_ms = (9 * E + 1 + 4 * n) / HBM_BYTES_PER_S * 1e3
    op_ms = iters * 2 * (2 * E + n) / F32_OPS_PER_S * 1e3
    out["bound_ms"] = max(byte_ms, op_ms)
    out["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
    out["step_bound_ms"] = max((9 * E + 8 * n) / HBM_BYTES_PER_S * 1e3,
                               2 * (2 * E + n) / F32_OPS_PER_S * 1e3)
    return out


# ---------------------------------------------------------------------------
# the graph: §5.1 connectivity under 8 client threads, then a replay
# ---------------------------------------------------------------------------
def one_fetch(torch, module, fn):
    """Run ``fn()`` on the card with every synchronising call raising
    (``torch.cuda.set_sync_debug_mode("error")``), except ``module``'s
    ``_host_fetch``, which is counted and must run exactly once."""
    real = module._host_fetch
    calls = []

    def counting(tree):
        calls.append(1)
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(tree)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    module._host_fetch = counting
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        module._host_fetch = real
    check(len(calls) == 1, f"{len(calls)} blocking fetches, want 1")
    return got


def drive_mixed(engine, threads, ops, seed, draw):
    """``threads`` clients of ``draw(rng) -> (method, input)``; returns
    every client's ``(method, input, answer)`` list and the seconds."""
    logs = [[] for _ in range(threads)]
    errors = []

    def client(tid):
        try:
            r = np.random.default_rng([seed, 9, tid])
            for _ in range(ops):
                m, i = draw(r)
                logs[tid].append((m, i, engine.execute(m, i)))
        except BaseException as exc:       # re-raised on the main thread
            errors.append(exc)

    ts = [threading.Thread(target=client, args=(t,), daemon=True)
          for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    check(not any(t.is_alive() for t in ts), "client threads hung")
    if errors:
        raise errors[0]
    return logs, seconds


def _norm(e):
    return (min(e), max(e))


def graph_replay(torch, g, tree, n_replay, seed):
    """Seeded single-thread combined update+read batches through the
    kernel pass and the plain pass on clones of ``g``'s state: every
    state field bit-equal after each batch, update answers equal to the
    port's ``DynamicGraph`` after each batch and reads every 10th batch
    and at the end; on the card every 10th kernel batch runs under
    :func:`one_fetch`.  Returns (batches, full rebuilds, fast merges)."""
    from repro_torch.core import device_graph as dg
    from repro_torch.core.dynamic_graph import DynamicGraph
    from repro_torch.kernels.label_prop import propagate_plain

    rng = np.random.default_rng([seed, 10])
    live = g.edges()
    pair = []
    for prop in (None, propagate_plain):
        h = dg.DeviceGraph(g.n, edge_capacity=g.capacity, c_max=g.c_max,
                           n_shards=g.n_shards, device=g.device)
        h.state = dg.clone_state(g.state)
        h._n_edges = len(live)
        if prop is not None:
            h._prop = prop
        pair.append(h)
    gk, gp = pair
    host = DynamicGraph(g.n, device=g.device)
    host.edges = set(live)
    n = g.n
    for b in range(n_replay):
        kind = b % 4     # inserts, mixed, delete-heavy, a few inserts
        k = int(rng.integers(1, 5)) if kind == 3 else \
            int(rng.integers(1, 2 * C_MAX + 9))
        ms, ins = [], []
        for _ in range(k):
            e = tree[int(rng.integers(len(tree)))]
            if rng.random() < 0.1:
                e = (e[0], e[0])                          # self-loop
            elif ins and rng.random() < 0.2:
                e = ins[int(rng.integers(len(ins)))]      # duplicate
            if kind in (0, 3):
                m = "insert"
            elif kind == 1:
                m = "insert" if rng.random() < 0.5 else "delete"
            else:
                m = "delete" if rng.random() < 0.8 else "insert"
            ms.append(m)
            ins.append(e)
        q = [(int(rng.integers(n)), int(rng.integers(n))) for _ in range(8)]
        q += [(e[0], e[1]) for e in ins[:8]]
        if b % 10 == 0 and g.device.type == "cuda":
            hk, ak = one_fetch(torch, dg, lambda: (
                gk.update_batch_async(ms, ins), gk.connected_batch(q)))
        else:
            hk = gk.update_batch_async(ms, ins)
            ak = gk.connected_batch(q)
        hp = gp.update_batch_async(ms, ins)
        ap = gp.connected_batch(q)
        check(all(torch.equal(x, y) for x, y in zip(gk.state, gp.state)),
              f"graph replay batch {b}: kernel state != plain state")
        rk = hk.result()
        check(rk == hp.result() and ak == ap,
              f"graph replay batch {b}: kernel answers != plain answers")
        want = [host.apply(m, e) for m, e in zip(ms, ins)]
        check(rk == want, f"graph replay batch {b}: updates {rk} != "
                          f"DynamicGraph {want}")
        if b % 10 == 9 or b == n_replay - 1:
            check(ak == host.read_batch(["connected"] * len(q), q),
                  f"graph replay batch {b}: reads != DynamicGraph")
    check(gk.edges() == host.edges, "graph replay: final edge sets differ")
    return (n_replay, gk.full_rebuilds() - g.full_rebuilds(),
            gk.fast_merges() - g.fast_merges())


def graph_phase(torch, dev, seed, n, threads, ops, n_replay, counters):
    from repro_torch.core.device_graph import DeviceGraph
    from repro_torch.core.read_opt import batched_read_optimized
    from repro_torch.kernels.label_prop.ref import components_reference

    rng = np.random.default_rng([seed, 5])
    tu, tv = random_tree(rng, n)
    tree = list(zip(tu.tolist(), tv.tolist()))
    g = DeviceGraph(n, edge_capacity=(n - 1) + 2 * C_MAX, c_max=C_MAX,
                    n_shards=4, device=dev)
    half = np.flatnonzero(np.random.default_rng([seed, 6]).random(n - 1)
                          < 0.5)
    batch = [tree[i] for i in half]
    t0 = time.perf_counter()
    check(all(g.insert_batch(batch)), "graph: a prepopulated edge refused")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prepop_s = time.perf_counter() - t0
    initial = {_norm(e) for e in batch}
    g.connected_batch([(0, 1)])               # labels current before
    rebuilds0, fast0 = g.full_rebuilds(), g.fast_merges()
    elim0 = g.eliminated_ops
    engine = batched_read_optimized(g)

    def draw(r):
        p = r.random() * 100
        if p < READ_PCT:
            return "connected", (int(r.integers(n)), int(r.integers(n)))
        e = tree[int(r.integers(len(tree)))]
        return ("insert" if p < READ_PCT + (100 - READ_PCT) / 2
                else "delete"), e

    (logs, seconds), launches = counted(
        torch, dev, "graph", counters, ("label_prop",),
        lambda: drive_mixed(engine, threads, ops, seed, draw))
    rebuilds = g.full_rebuilds() - rebuilds0
    fast = g.fast_merges() - fast0
    check(rebuilds > 0, "graph: no full rebuild on the main path")
    check(fast > 0, "graph: no fast-path merge on the main path")
    # per-edge-class conservation
    delta = {}
    for log in logs:
        for m, e, res in log:
            if m != "connected" and res:
                delta[_norm(e)] = delta.get(_norm(e), 0) + (
                    1 if m == "insert" else -1)
    final = g.edges()
    for e in initial | set(delta) | final:
        want = (e in initial) + delta.get(e, 0)
        check(want in (0, 1) and (e in final) == bool(want),
              f"graph: edge {e} not conserved ({want}, {e in final})")
    labels = np.asarray(g.labels(), np.int32)
    check(np.array_equal(labels, components_reference(n, final)),
          "graph: final labels != the union-find oracle")
    n_ops = threads * ops
    stats = {
        "ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
        "passes": engine.passes,
        "mean_batch": float(np.mean(engine.combined_sizes)),
        "eliminated": g.eliminated_ops - elim0,
        "full_rebuilds": rebuilds, "fast_merges": fast,
        "launches": launches, "prepopulate_s": prepop_s,
        "live_edges": len(final),
        "device_bytes": sum(t.numel() * t.element_size() for t in g.state),
    }
    stats["replayed"], stats["replay_rebuilds"], stats["replay_merges"] = \
        graph_replay(torch, g, tree, n_replay, seed)
    return stats


# ---------------------------------------------------------------------------
# the union-find under 8 client threads, then a replay
# ---------------------------------------------------------------------------
def uf_replay(torch, uf, n_replay, seed):
    """Seeded union batches through the kernel pass and the plain pass on
    clones of ``uf``'s labels (bit-equal after every batch), answers equal
    to ``SequentialUnionFind.update_batch`` (reads every 10th batch)."""
    from repro_torch.core.batched_union_find import BatchedUnionFind, UFState
    from repro_torch.core.seq_union_find import SequentialUnionFind
    from repro_torch.kernels.label_prop import propagate_plain

    rng = np.random.default_rng([seed, 11])
    n = uf.n
    uk = BatchedUnionFind(n, c_max=uf.c_max, device=uf.device)
    up = BatchedUnionFind(n, c_max=uf.c_max, device=uf.device)
    uk.state = UFState(uf.state.labels.clone())
    up.state = UFState(uf.state.labels.clone())
    up._prop = propagate_plain
    oracle = SequentialUnionFind(n)
    oracle.load_labels(uf.labels())
    for b in range(n_replay):
        k = int(rng.integers(1, 2 * C_MAX + 5))
        ins = []
        for _ in range(k):
            if ins and rng.random() < 0.15:
                ins.append(ins[int(rng.integers(len(ins)))])   # repeat
                continue
            u = int(rng.integers(n))
            ins.append((u, (u + 1) % n) if rng.random() < 0.5
                       else (u, int(rng.integers(n))))
        ms = ["union"] * k
        rk, rp = uk.update_batch(ms, ins), up.update_batch(ms, ins)
        check(torch.equal(uk.state.labels, up.state.labels),
              f"unionfind replay batch {b}: kernel labels != plain labels")
        want = oracle.update_batch(ms, ins)
        check(rk == rp == want, f"unionfind replay batch {b}: {rk} != "
                                f"oracle {want}")
        if b % 10 == 9:
            qm = ["find", "connected", "components"]
            qi = [ins[0][0], (ins[0][0], ins[-1][1]), None]
            check(uk.read_batch(qm, qi) == oracle.read_batch(qm, qi),
                  f"unionfind replay batch {b}: reads != oracle")
    check(uk.labels() == oracle.labels(),
          "unionfind replay: final labels != oracle")
    return n_replay


def uf_phase(torch, dev, seed, n, threads, ops, n_replay, counters):
    from repro_torch.core.batched_union_find import BatchedUnionFind
    from repro_torch.core.pc_union_find import pc_union_find
    from repro_torch.kernels.label_prop.ref import components_reference

    uf = BatchedUnionFind(n, c_max=C_MAX, device=dev)
    engine = pc_union_find(uf)

    def draw(r):
        p = r.random() * 100
        if p < READ_PCT:
            k = int(r.integers(3))
            if k == 0:
                return "find", int(r.integers(n))
            if k == 1:
                return "connected", (int(r.integers(n)), int(r.integers(n)))
            return "components", None
        u = int(r.integers(n))
        return "union", ((u, (u + 1) % n) if r.random() < 0.5
                         else (u, int(r.integers(n))))

    (logs, seconds), launches = counted(
        torch, dev, "unionfind", counters, ("label_prop",),
        lambda: drive_mixed(engine, threads, ops, seed, draw))
    unions = [i for log in logs for m, i, _ in log if m == "union"]
    check(np.array_equal(np.asarray(uf.labels(), np.int32),
                         components_reference(n, unions)),
          "unionfind: final labels != the oracle of every union")
    n_ops = threads * ops
    return {
        "ops": n_ops, "seconds": seconds, "ops_per_s": n_ops / seconds,
        "passes": engine.passes,
        "mean_batch": float(np.mean(engine.combined_sizes)),
        "unions": len(unions), "launches": launches,
        "device_bytes": uf.state.labels.numel() * 4,
        "replayed": uf_replay(torch, uf, n_replay, seed),
    }


def _profile(torch, name, one, n_passes, what, out):
    """Host time per call of ``one()`` over ``n_passes`` (after 20
    warm-up calls), then 100 calls under torch.profiler: device time and
    busy share, kernel launches and memcpy calls per call, the
    hand-written kernels' device time per launch, the busiest ops."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):                       # warm-up
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_passes):
        one()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n_passes * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(100):
            one()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka)
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"))
    memcpy = sum(e.count for e in ka if e.key.startswith("cudaMemcpy"))
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:6]
    ours = [f"{k} {e.self_device_time_total / e.count:.3f} us/launch "
            f"x {e.count}" for k in REPLACES for e in ka
            if f"{k}_kernel(" in e.key and e.count]
    out(f"profile {name}: single-thread pass {host_ms:.3f} ms (host "
        f"clock, {n_passes} passes of {what}); under the profiler "
        f"{prof_wall * 10:.3f} ms/pass wall, device "
        f"{dev_us / 100 / 1e3:.4f} ms/pass (busy share "
        f"{dev_us / 1e6 / prof_wall:.4f}), {launches / 100:.1f} kernel "
        f"launches and {memcpy / 100:.1f} memcpy calls per pass; "
        f"hand-written kernels on the device: " + "; ".join(ours)
        + "; top device ops: " + "; ".join(
            f"{e.key} {e.self_device_time_total / 100:.2f} us/pass"
            for e in top))


def profile_passes(seed=0, n_keys=N_KEYS, n_passes=300, width=4,
                   threads=THREADS, ops=300, n=GRAPH_VERTICES, out=print):
    """``--profile``: where a pass's time goes, at the main paths' sizes.
    For both queues: (1) ``n_passes`` single-thread ``apply`` calls of up
    to ``width`` extracts + inserts each (the threaded runs' mean batch
    is about 4), host clock, then 100 under torch.profiler
    (:func:`_profile`); (2) the same queue under ``threads`` clients, host
    time per combining pass.  For the graph (half a random tree of n
    vertices live, loaded straight into the edge buffer) and the
    union-find: single-thread combining passes of one update and three
    reads (about the threaded runs' mean batch), as the combiner runs
    them, through :func:`_profile`."""
    import torch

    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq
    from repro_torch.core.batched_union_find import BatchedUnionFind
    from repro_torch.core.device_graph import DeviceGraph
    from repro_torch.core.pc_pq import pc_priority_queue

    dev = torch.device("cuda")
    rng = np.random.default_rng([seed, 0])
    init = rng.uniform(0, KEY_RANGE, n_keys).astype(np.float32)
    total = n_keys + 2 * n_passes * width + threads * ops + 2
    for name, pq in (
            ("pq-single", bpq.BatchedPriorityQueue(
                shard_capacity(total, 1), C_MAX, values=init, device=dev)),
            ("pq-sharded", spq.ShardedBatchedPQ(
                shard_capacity(total, 4), C_MAX, n_shards=4, values=init,
                device=dev))):
        r = np.random.default_rng([seed, 4])

        def one():
            ins = r.uniform(0, KEY_RANGE, int(r.integers(0, width + 1)))
            pq.apply(int(r.integers(0, width + 1)), ins.astype(np.float32))

        _profile(torch, name, one, n_passes,
                 f"<= {width}+{width} ops", out)
        engine = pc_priority_queue(pq)
        _, _, seconds = drive(engine, threads, ops, seed)
        torch.cuda.synchronize()
        out(f"profile {name}: {threads} threads x {ops} ops: "
            f"{seconds / engine.passes * 1e3:.3f} ms per combining pass, "
            f"mean batch {float(np.mean(engine.combined_sizes)):.3f}, "
            f"{threads * ops / seconds:.1f} ops/s")
        del pq, engine

    r = np.random.default_rng([seed, 12])
    tu, tv = random_tree(r, n)
    tree = list(zip(tu.tolist(), tv.tolist()))
    g = DeviceGraph(n, edge_capacity=(n - 1) + 2 * C_MAX, c_max=C_MAX,
                    n_shards=4, device=dev)
    half = r.random(n - 1) < 0.5
    m = int(half.sum())
    g.state.eu[:m] = torch.from_numpy(np.minimum(tu, tv)[half]).to(dev)
    g.state.ev[:m] = torch.from_numpy(np.maximum(tu, tv)[half]).to(dev)
    g.state.valid[:m] = True
    g.state.dirty_full.fill_(True)
    g._n_edges, g._maybe_stale = m, True
    for name, ds, update in (
            ("graph", g, lambda: (
                "insert" if r.random() < 0.5 else "delete",
                tree[int(r.integers(len(tree)))])),
            ("unionfind", BatchedUnionFind(n, c_max=C_MAX, device=dev),
             lambda: ("union", (int(r.integers(n)), int(r.integers(n)))))):
        def one():
            # one combining pass as batched_read_optimized runs it: the
            # update dispatched, the reads answered by one read pass
            # whose fetch also resolves the update's result
            m, e = update()
            h = ds.update_batch_async([m], [e])
            ds.read_batch(["connected"] * 3,
                          [(int(r.integers(n)), int(r.integers(n)))
                           for _ in range(3)])
            h.result()

        _profile(torch, name, one, n_passes,
                 "one update + three connected", out)


def run(dev_name="cuda", seed=0, n_keys=N_KEYS, threads=THREADS,
        ops=OPS_PER_THREAD, n_replay=REPLAY_BATCHES, n_cases=24,
        graph_vertices=GRAPH_VERTICES, graph_ops=GRAPH_OPS,
        graph_replay=GRAPH_REPLAY, uf_replay=UF_REPLAY, timing=True,
        out=print):
    """Phases 2–8; returns the kernel records and each path's stats.
    (``dev_name="cpu"`` with small sizes and ``timing=False`` rehearses
    the control flow on the host, where the wrappers run their plain
    versions.)"""
    import torch

    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq
    from repro_torch.core.pc_pq import (pc_priority_queue,
                                        pc_sharded_priority_queue)
    from repro_torch.kernels import (_build, heap_insert, heap_kmin,
                                     heap_sift, label_prop)

    dev = torch.device(dev_name)
    counters = {"heap_kmin": heap_kmin.k_smallest_sharded,
                "heap_sift": heap_sift.sift_wavefront_sharded,
                "heap_insert": heap_insert.phase4_sharded,
                "label_prop": label_prop.propagate}

    if dev.type == "cuda":
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        report = [ln.strip() for ln in (lib.parent / "build.log")
                  .read_text().splitlines() if "registers" in ln]
        out(f"build: {time.perf_counter() - t0:.1f} s, {lib}; ptxas: "
            + " | ".join(report))

    extra = n_replay * C_MAX + 2
    total = n_keys + threads * ops + extra
    cap1 = shard_capacity(total, 1)
    cap4 = shard_capacity(total, 4)
    checked, timed = kernel_phase(torch, dev, seed, [(1, cap1), (4, cap4)],
                                  n_cases)
    times = time_kernels(torch, timed) if timing else {}
    for name in ("heap_kmin", "heap_sift", "heap_insert"):
        t = times.get(name, {})
        out(f"kernels: {name} == plain on {checked.calls[name]} passes "
            f"(max_abs_err {checked.max_abs_err[name]}); "
            + ("timing not measured" if not t else
               f"ms {t['ms']:.6f} plain_ms {t['plain_ms']:.6f} "
               f"bound_ms {t['bound_ms']:.3e} ({t['bound_by']}) "
               f"library_ms {t['library_ms']}"))
    t0 = time.perf_counter()
    lp_chk, lp_timed, lp_steps = label_prop_phase(torch, dev, seed,
                                                  graph_vertices)
    checked.calls["label_prop"] = lp_chk.calls
    checked.max_abs_err["label_prop"] = lp_chk.max_abs_err
    if timing:
        times["label_prop"] = time_label_prop(torch, lp_timed)
    t = times.get("label_prop", {})
    out(f"kernels: label_prop == plain on {lp_chk.calls} launches (max_abs_"
        f"err {lp_chk.max_abs_err}; fixpoint steps {lp_steps}; "
        f"{time.perf_counter() - t0:.1f} s); " + (
            "timing not measured" if not t else
            f"full rebuild ms {t['ms']:.6f} ({t['fixpoint_steps']} steps, "
            f"n {t['n']}, {t['edge_slots']} edge slots, {t['live_edges']} "
            f"live) plain_ms {t['plain_ms']:.6f} bound_ms "
            f"{t['bound_ms']:.3e} ({t['bound_by']}); step ms "
            f"{t['step_ms']:.6f} plain {t['step_plain_ms']:.6f} bound "
            f"{t['step_bound_ms']:.3e}; merge ms {t['merge_ms']:.6f}; "
            f"library_ms None"))

    rng = np.random.default_rng([seed, 0])
    init = rng.uniform(0, KEY_RANGE, n_keys).astype(np.float32)
    results = {}
    for name, make, pass_fn in (
            ("pq-single",
             lambda: pc_priority_queue(bpq.BatchedPriorityQueue(
                 cap1, C_MAX, values=init, device=dev)),
             lambda st, ne, v, ni, **kw: bpq.apply_batch_impl(
                 st, ne, v, ni, c_max=C_MAX, **kw)),
            ("pq-sharded",
             lambda: pc_sharded_priority_queue(cap4, C_MAX, n_shards=4,
                                               values=init, device=dev),
             lambda st, ne, v, ni, **kw: spq._sharded_apply_batch(
                 st, ne, v, ni, c_max=C_MAX, n_shards=4, **kw))):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        engine = make()
        s = pq_phase(torch, name, engine, init, counters, seed, threads,
                     ops, n_replay, pass_fn, bpq.PLAIN_PHASES)
        if dev.type == "cuda":
            s["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        results[name] = s
        out(f"{name}: {s['ops_per_s']:.1f} ops/s ({s['ops']} ops in "
            f"{s['seconds']:.3f} s, {threads} threads), passes "
            f"{s['passes']}, mean batch {s['mean_batch']:.3f}, eliminated "
            f"{s['eliminated']}, launches {s['launches']}, heap bytes "
            f"{s['heap_bytes']}, max_memory_allocated "
            f"{s.get('max_memory_allocated', 'n/a')}; conservation, heap "
            f"property and {s['replayed']}-batch kernel==plain replay ok")
        del engine

    for name, phase, n_rep in (("graph", graph_phase, graph_replay),
                               ("unionfind", uf_phase, uf_replay)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = phase(torch, dev, seed, graph_vertices, threads, graph_ops,
                  n_rep, counters)
        if dev.type == "cuda":
            s["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        results[name] = s
        extra = (f"prepopulated {s['live_edges']} live edges in "
                 f"{s['prepopulate_s']:.3f} s; eliminated {s['eliminated']}"
                 f", full rebuilds {s['full_rebuilds']}, fast merges "
                 f"{s['fast_merges']}; replay rebuilds "
                 f"{s['replay_rebuilds']}, merges {s['replay_merges']}"
                 if name == "graph" else f"{s['unions']} unions")
        out(f"{name}: {s['ops_per_s']:.1f} ops/s ({s['ops']} ops in "
            f"{s['seconds']:.3f} s, {threads} threads, {READ_PCT}% reads), "
            f"passes {s['passes']}, mean batch {s['mean_batch']:.3f}, "
            f"{extra}, launches {s['launches']}, device bytes "
            f"{s['device_bytes']}, max_memory_allocated "
            f"{s.get('max_memory_allocated', 'n/a')}; checks and "
            f"{s['replayed']}-batch kernel==plain replay ok "
            f"({time.perf_counter() - t0:.1f} s)")

    paths = {"heap_kmin": ("pq-single", "pq-sharded"),
             "heap_sift": ("pq-single", "pq-sharded"),
             "heap_insert": ("pq-single", "pq-sharded"),
             "label_prop": ("graph", "unionfind")}
    kernels = []
    for name in counters:
        t = times.get(name, {})
        rec = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the driven paths together, and each path's own count
            "launches": sum(results[p]["launches"][name]
                            for p in paths[name]),
            "launches_by_path": {p: results[p]["launches"][name]
                                 for p in paths[name]},
            "max_abs_err": checked.max_abs_err[name],
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
        }
        if name == "label_prop":
            rec.update({k: t.get(k) for k in (
                "step_ms", "step_plain_ms", "step_bound_ms", "merge_ms",
                "fixpoint_steps")})
        kernels.append(rec)
    return kernels, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="only the pass-time breakdown (profile_passes), "
                         "not the checks")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs the "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}, {torch.cuda.device_count()} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    if args.profile:
        profile_passes(seed=args.seed)
        return 0
    kernels, _ = run("cuda", seed=args.seed)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
