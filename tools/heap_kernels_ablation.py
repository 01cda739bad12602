#!/usr/bin/env python3
"""Time ``heap_insert`` and ``heap_sift`` as built beside an earlier
version of both and beside ``heap_sift`` at k = 1..5 levels a round trip,
on one GPU.

    python3 tools/heap_kernels_ablation.py [--parent DIR] [--seed 0]
        [--rounds 2] [--passes 200]

Variants, each compiled with the package's ``nvcc`` flags (``heap_sift.cu``
and ``heap_insert.cu`` into one library under
``build/heap_ablation/<variant>/``):

- ``as_built``: the two sources as they are;
- ``parent``: ``DIR/src/repro_torch/kernels/csrc/heap_{sift,insert}.cu``,
  with ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked
  from ``git archive``; its entry points must take the same arguments);
- ``k1`` .. ``k5``: ``heap_sift.cu`` with ``kSiftLevels`` (the levels a
  cursor decides a round trip) set to 1..5 (``heap_insert.cu`` as built).

Each variant's entry points stand in for the package's own (the package
library keeps every other kernel), and for each variant:

1. the K = 4 inputs that ``chip_smoke.py``'s kernel checks keep for timing
   (4,000,000 keys, 1,005,215 slots a shard): the result held bit-equal to
   the plain version, then the per-launch ms by ``chip_smoke.py``'s held
   CUDA-event windows, every launch on its own copy of the heap, so the
   ring of 30 copies outruns the L2 and each launch finds the heap cold;
2. in situ: ``--passes`` single-thread ``apply`` calls of up to 4 extracts
   and 4 inserts each (``chip_smoke.py --profile``'s passes) on
   ``pq-single`` and ``pq-sharded`` at 4,000,000 keys, every variant from
   the same seeded queue, under torch.profiler: each kernel's device time
   a launch.

Rounds visit the variants in alternating order; the medians are printed,
one JSON line last.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "heap_ablation"
FILES = ("heap_sift.cu", "heap_insert.cu")
ENTRIES = ("heap_sift_launch", "heap_insert_launch")
LEVELS = "constexpr int kSiftLevels = 4; "
KERNELS = {"heap_sift": "heap_sift", "heap_insert": "heap_insert"}


def sources(parent):
    """variant -> {file name: source text}."""
    built = {f: (CSRC / f).read_text() for f in FILES}
    if built["heap_sift.cu"].count(LEVELS) != 1:
        raise RuntimeError(f"heap_sift.cu: {LEVELS!r} not found once")
    out = {"as_built": built}
    if parent is not None:
        d = Path(parent) / "src" / "repro_torch" / "kernels" / "csrc"
        out["parent"] = {f: (d / f).read_text() for f in FILES}
    for k in range(1, 6):
        out[f"k{k}"] = dict(built, **{"heap_sift.cu": built[
            "heap_sift.cu"].replace(LEVELS, f"constexpr int kSiftLevels = "
                                            f"{k}; ")})
    return out


def build(nvcc, cflags, variants):
    """Compile every variant at once; return name -> (library, ptxas log)."""
    procs = {}
    for name, srcs in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        paths = []
        for f, text in srcs.items():
            (d / f).write_text(text)
            paths.append(str(d / f))
        procs[name] = subprocess.Popen(
            [nvcc, *cflags, "-Xptxas", "-v", "-shared", "-o",
             str(d / "libheap.so"), *paths],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (OUT / name / "libheap.so", log)
    return out


class Swapped:
    """The package's library with the heap entry points of a variant."""

    def __init__(self, base, variant):
        self._base, self._variant = base, variant

    def __getattr__(self, name):
        return getattr(self._variant if name in ENTRIES else self._base,
                       name)


def in_situ(torch, cs, make, passes, seed):
    """Device us a launch of each heap kernel over ``passes`` profiled
    single-thread passes of a queue from ``make()``."""
    from torch.profiler import ProfilerActivity, profile

    pq = make()
    r = np.random.default_rng([seed, 4])

    def one():
        ins = r.uniform(0, cs.KEY_RANGE, int(r.integers(0, 5)))
        pq.apply(int(r.integers(0, 5)), ins.astype(np.float32))

    for _ in range(20):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            one()
        torch.cuda.synchronize()
    rows = cs.device_rows(prof.key_averages())
    out = {}
    for name, key in KERNELS.items():
        mine = [e for e in rows if key in e.key and "_kernel" in e.key]
        n = sum(e.count for e in mine)
        out[name] = (sum(e.self_device_time_total for e in mine) / n
                     if n else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--passes", type=int, default=200)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("heap_kernels_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq
    from repro_torch.kernels import _build, heap_insert, heap_sift

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    base = _build.library()
    nvcc = _build.nvcc_path()
    cufilt = str(Path(nvcc).parent / "cu++filt")
    libs = {}
    for name, (path, log) in build(nvcc, _build.CFLAGS,
                                   sources(args.parent)).items():
        lib = ctypes.CDLL(str(path))
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = Swapped(base, lib)
        frames = re.findall(r"(\d+) bytes stack frame", log)
        print(f"{name}: " + "; ".join(
            f"{k} {r} regs, spills {st} / {ld}, stack frame {f} bytes"
            for (_, k, r, st, ld), f in zip(
                cs.ptxas_report(log, cufilt), frames)))

    dev = torch.device("cuda")
    cap1, cap4 = cs.pq_capacities(cs.N_KEYS, cs.THREADS, cs.OPS_PER_THREAD,
                                  cs.REPLAY_BATCHES)
    _, timed = cs.kernel_phase(torch, dev, args.seed, [(4, cap4)], 4)
    s_in = timed["heap_sift"]
    i_in = timed["heap_insert"]
    want_s = heap_sift.sift_wavefront_plain(s_in[0].clone(), *s_in[1:])
    want_i = heap_insert.phase4_plain(i_in[0].clone(), *i_in[1:])
    fns = {
        "heap_sift": lambda a: heap_sift.sift_wavefront_sharded(a, *s_in[1:]),
        "heap_insert": lambda a: heap_insert.phase4_sharded(a, *i_in[1:]),
    }
    rng = np.random.default_rng([args.seed, 0])
    init = rng.uniform(0, cs.KEY_RANGE, cs.N_KEYS).astype(np.float32)
    total = cs.N_KEYS + 2 * (args.passes + 20) * 4 + 2
    queues = {
        "pq-single": lambda: bpq.BatchedPriorityQueue(
            cs.shard_capacity(total, 1), cs.C_MAX, values=init, device=dev),
        "pq-sharded": lambda: spq.ShardedBatchedPQ(
            cs.shard_capacity(total, 4), cs.C_MAX, n_shards=4, values=init,
            device=dev)}
    ring = [torch.empty_like(s_in[0]) for _ in range(cs.RING)]
    order = list(libs)
    cold = {(v, k): [] for v in order for k in fns}
    situ = {(v, q, k): [] for v in order for q in queues for k in fns}
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            _build._lib = libs[name]
            a = s_in[0].clone()
            fns["heap_sift"](a)
            cs.check(torch.equal(a, want_s), f"{name}: heap_sift != plain")
            a = i_in[0].clone()
            _, size = fns["heap_insert"](a)
            cs.check(torch.equal(a, want_i[0]) and torch.equal(
                size, want_i[1].to(size.dtype)),
                f"{name}: heap_insert != plain")
            for k, fn in fns.items():
                a_in = s_in[0] if k == "heap_sift" else i_in[0]
                cold[name, k].append(cs._per_launch_ms(
                    torch, fn, ring, a_in, hold=True))
            for q, make in queues.items():
                for k, us in in_situ(torch, cs, make, args.passes,
                                     args.seed).items():
                    situ[name, q, k].append(us)
                torch.cuda.empty_cache()
            _build._lib = base
    rec = {}
    for name in order:
        rec[name] = {f"{k}_cold_ms": float(np.median(cold[name, k]))
                     for k in fns}
        for q in queues:
            for k in fns:
                vals = [x for x in situ[name, q, k] if x is not None]
                rec[name][f"{k}_in_situ_ms_{q}"] = (
                    float(np.median(vals)) / 1e3 if vals else None)
        print(f"{name} (median of {args.rounds} rounds): " + "; ".join(
            f"{key} {val:.6f}" if val is not None else f"{key} none"
            for key, val in rec[name].items()))
    print(json.dumps({"heap_kernels_ablation": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
