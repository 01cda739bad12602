#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA device and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use).  Phases,
each printing a line:

1. ``device`` — the card's name, then ``nvidia-smi``'s name and power limit.
2. ``build`` — the three kernels compiled for ``sm_90a`` (time, ptxas report).
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
C_MAX = 16                     # bench_pq.C_MAX
N_KEYS = 4_000_000             # initial keys of the pq phases
THREADS = 8
OPS_PER_THREAD = 2000
REPLAY_BATCHES = 240
KEY_RANGE = 2 ** 31 - 1
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
REPLACES = {
    "heap_kmin": "src/repro/kernels/heap_kmin/kernel.py:86",
    "heap_sift": "src/repro/kernels/heap_sift/kernel.py:115",
    "heap_insert": "src/repro/kernels/heap_insert/kernel.py:170",
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


def pq_phase(torch, name, engine, init, counters, seed, threads, ops,
             n_replay, pass_fn, plain_phases):
    from repro_torch.core.batched_pq import check_heap_property

    pq = engine.pq
    for fn in counters.values():
        fn.launches = 0
    ins, ext, seconds = drive(engine, threads, ops, seed)
    if pq.state.a.device.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if pq.state.a.device.type == "cuda":
        for k, n in launches.items():
            check(n > 0, f"{name}: kernel {k} was never launched on the "
                         f"main path")
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


def profile_passes(seed=0, n_keys=N_KEYS, n_passes=300, width=4,
                   threads=THREADS, ops=300, out=print):
    """``--profile``: where a pass's time goes, for both queues at the
    main path's size.  (1) ``n_passes`` single-thread ``apply`` calls of
    up to ``width`` extracts + inserts each (the threaded runs' mean
    batch is about 4), host clock; (2) 100 of them under torch.profiler:
    device time per pass, kernel launches per pass, the busiest device
    ops; (3) the same queue under ``threads`` clients, host time per
    combining pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq
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
            "cuLaunchKernelEx"))
        memcpy = sum(e.count for e in ka if e.key.startswith("cudaMemcpy"))
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:6]
        ours = [f"{k} {e.self_device_time_total / e.count:.3f} us/launch "
                f"x {e.count}" for k in REPLACES for e in ka
                if f"{k}_kernel(" in e.key and e.count]
        out(f"profile {name}: single-thread pass {host_ms:.3f} ms (host "
            f"clock, {n_passes} passes of <= {width}+{width} ops); under "
            f"the profiler {prof_wall * 10:.3f} ms/pass wall, device "
            f"{dev_us / 100 / 1e3:.4f} ms/pass (busy share "
            f"{dev_us / 1e6 / prof_wall:.4f}), {launches / 100:.1f} kernel "
            f"launches and {memcpy / 100:.1f} memcpy calls per pass; "
            f"hand-written kernels on the device: " + "; ".join(ours)
            + "; top device ops: " + "; ".join(
                f"{e.key} {e.self_device_time_total / 100:.2f} us/pass"
                for e in top))

        engine = pc_priority_queue(pq)
        _, _, seconds = drive(engine, threads, ops, seed)
        torch.cuda.synchronize()
        out(f"profile {name}: {threads} threads x {ops} ops: "
            f"{seconds / engine.passes * 1e3:.3f} ms per combining pass, "
            f"mean batch {float(np.mean(engine.combined_sizes)):.3f}, "
            f"{threads * ops / seconds:.1f} ops/s")


def run(dev_name="cuda", seed=0, n_keys=N_KEYS, threads=THREADS,
        ops=OPS_PER_THREAD, n_replay=REPLAY_BATCHES, n_cases=24,
        timing=True, out=print):
    """Phases 2–5; returns the kernel records.  (``dev_name="cpu"`` with
    small sizes and ``timing=False`` rehearses the control flow on the
    host, where the wrappers run their plain versions.)"""
    import torch

    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq
    from repro_torch.core.pc_pq import (pc_priority_queue,
                                        pc_sharded_priority_queue)
    from repro_torch.kernels import _build, heap_insert, heap_kmin, heap_sift

    dev = torch.device(dev_name)
    counters = {"heap_kmin": heap_kmin.k_smallest_sharded,
                "heap_sift": heap_sift.sift_wavefront_sharded,
                "heap_insert": heap_insert.phase4_sharded}

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
    for name in counters:
        t = times.get(name, {})
        out(f"kernels: {name} == plain on {checked.calls[name]} passes "
            f"(max_abs_err {checked.max_abs_err[name]}); "
            + ("timing not measured" if not t else
               f"ms {t['ms']:.6f} plain_ms {t['plain_ms']:.6f} "
               f"bound_ms {t['bound_ms']:.3e} ({t['bound_by']}) "
               f"library_ms {t['library_ms']}"))

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

    kernels = []
    for name in counters:
        t = times.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the driven paths together, and each path's own count
            "launches": sum(r["launches"][name] for r in results.values()),
            "launches_by_path": {path: r["launches"][name]
                                 for path, r in results.items()},
            "max_abs_err": checked.max_abs_err[name],
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"),
        })
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
