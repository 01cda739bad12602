#!/usr/bin/env python3
"""Time ``heap_kmin`` and ``sorted_merge`` as built beside an earlier
version of both, beside ``heap_kmin`` at other cached top levels T and
miss-subtree levels k, and beside ``sorted_merge`` at other tile widths,
on one GPU.

    python3 tools/kmin_merge_ablation.py [--parent DIR] [--seed 0]
        [--rounds 2] [--passes 200] [--only as_built,parent,...]

Variants, each compiled with the package's ``nvcc`` flags (``heap_kmin.cu``
and ``sorted_merge.cu`` into one library under
``build/kmin_merge_ablation/<variant>/``):

- ``as_built``: the two sources as they are;
- ``parent``: ``DIR/src/repro_torch/kernels/csrc/{heap_kmin,sorted_merge}.cu``
  with ``--parent DIR`` (a checkout of the commit before the redesign,
  e.g. unpacked from ``git archive``: its ``heap_kmin`` entry point takes
  the same arguments, its ``sorted_merge`` entry point the cooperative
  form's, called here as that commit's wrapper called it);
- ``T<t>k<k>``: ``heap_kmin.cu`` with ``kTopLevels`` = t and ``kSubLevels``
  = k (``sorted_merge.cu`` as built);
- ``items<n>``: ``sorted_merge.cu`` with ``kItems`` (A slots a thread; the
  tile is 256 n slots) = n (``heap_kmin.cu`` as built);
- ``threads<t>items<n>``: ``sorted_merge.cu`` with ``kThreads`` = t and
  ``kItems`` = n (a tile of t n slots);
- ``fenced``: ``sorted_merge.cu`` with a ``__threadfence()`` before each
  status word is published;
- ``trace``: ``sorted_merge.cu`` built with ``SORTED_MERGE_TRACE``: not
  timed; after the rounds, one launch on each ``sorted_merge`` input, and
  per CTA the time of each phase from its trace (median and largest over
  the tiles, in us by each CTA's ratio of global timer to clock), the
  span from the first CTA's start to the last one's end, and the pad
  CTAs' end.

Each variant's entry points stand in for the package's own (the package
library keeps every other kernel), and for each variant:

1. cold: the K = 4 ``heap_kmin`` input that ``chip_smoke.py``'s kernel
   checks keep for timing (4,000,000 keys, 16 extracts a shard, every
   launch on its own copy of the heap, so the ring of 30 copies outruns
   the L2), and ``chip_smoke.py``'s ``sorted_merge`` inputs at the map's
   shape (the map-fill pass, keep-none, empty A; each call into its own
   output pair): each result held bit-equal to the plain version, then the
   per-launch ms by ``chip_smoke.py``'s held CUDA-event windows;
   ``as_built`` also times ``heap_kmin`` at 1, 2, 4 and 8 extracts on the
   same heap (the steps' own cost);
2. in situ: ``--passes`` single-thread passes of ``chip_smoke.py
   --profile`` under torch.profiler, each kernel's device time a launch:
   ``heap_kmin`` in ``apply`` calls of up to 4 extracts and 4 inserts on
   ``pq-single`` and ``pq-sharded`` at 4,000,000 keys (every variant from
   the same seeded queue), ``sorted_merge`` in passes of one update and
   three reads on ``map`` and ``sketch`` at 1,000,000 keys (every variant
   from a copy of the same state).  ``T``/``k`` variants run the queues
   only, the other ``sorted_merge`` variants the map and sketch only.

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
OUT = ROOT / "build" / "kmin_merge_ablation"
FILES = ("heap_kmin.cu", "sorted_merge.cu")
KMIN_ENTRIES = ("heap_kmin_launch",)
MERGE_ENTRIES = ("sorted_merge_launch", "sorted_merge_scratch_words",
                 "sorted_merge_tile", "sorted_merge_max_lanes")
TOP = "constexpr int kTopLevels = {}; "
SUB = "constexpr int kSubLevels = {}; "
ITEMS = "constexpr int kItems = {}; "
KMIN_GRID = ([(t, 4) for t in (1, 4, 6, 7, 8)]
             + [(7, k) for k in (1, 2, 3, 5)])
MERGE_ITEMS = (4, 8, 16)
THREADS = "constexpr int kThreads = {}; "
MERGE_WIDE = ((512, 8), (512, 16))   # (threads, slots a thread)
TRACE_ON = "#define SORTED_MERGE_TRACE 1\n"
PUBLISH = ("__device__ __forceinline__ void publish(unsigned long long* p,\n"
           "                                        unsigned long long v) {\n")
# sorted_merge.cu's trace slots: global timer at the start, SM clock at the
# start, after the ticket, after B is staged (keep loaded), after the
# ranks (keys loaded, m searched), after the look-back, at the end;
# global timer at the end
PHASES = ("ticket", "keep", "keys_rank", "lookback", "place")
# the cooperative form's entry point: K, N, C, a_keys, stride, a_vals,
# stride, keep, stride, b_keys, stride, b_vals, stride, b_count, out keys,
# stride, out vals, stride, int32 scratch, stream
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_MERGE = [_I, _I, _I, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _P, _P,
                _L, _P, _L, _P, _P]


def _setting(text, pattern):
    """The value of the one ``pattern`` (``...= {}; ``) line in ``text``."""
    rx = re.escape(pattern).replace(r"\{\}", r"(\d+)")
    found = re.findall(rx, text)
    if len(found) != 1:
        raise RuntimeError(f"{pattern.format('N')!r} not found once")
    return int(found[0])


def _patch(text, pattern, value):
    old = pattern.format(_setting(text, pattern))
    return text.replace(old, pattern.format(value))


def sources(parent):
    """variant -> {file name: source text}."""
    built = {f: (CSRC / f).read_text() for f in FILES}
    out = {"as_built": built}
    if parent is not None:
        d = Path(parent) / "src" / "repro_torch" / "kernels" / "csrc"
        out["parent"] = {f: (d / f).read_text() for f in FILES}
    kmin = built["heap_kmin.cu"]
    for t, k in KMIN_GRID:
        out[f"T{t}k{k}"] = dict(built, **{"heap_kmin.cu": _patch(
            _patch(kmin, TOP, t), SUB, k)})
    for n in MERGE_ITEMS:
        out[f"items{n}"] = dict(built, **{"sorted_merge.cu": _patch(
            built["sorted_merge.cu"], ITEMS, n)})
    for n, i in MERGE_WIDE:
        out[f"threads{n}items{i}"] = dict(built, **{"sorted_merge.cu": _patch(
            _patch(built["sorted_merge.cu"], THREADS, n), ITEMS, i)})
    out["fenced"] = dict(built, **{"sorted_merge.cu": built[
        "sorted_merge.cu"].replace(PUBLISH, PUBLISH + "  __threadfence();\n")})
    out["trace"] = dict(built, **{"sorted_merge.cu": TRACE_ON
                                  + built["sorted_merge.cu"]})
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
             str(d / "libkm.so"), *paths],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (OUT / name / "libkm.so", log)
    return out


class Swapped:
    """The package's library with some entry points of a variant."""

    def __init__(self, base, variant, entries):
        self._base, self._variant, self._entries = base, variant, entries

    def __getattr__(self, name):
        return getattr(self._variant if name in self._entries else
                       self._base, name)


def parent_merge(torch, lib):
    """The cooperative form's merge entry point, called as its wrapper
    called it (a fresh int32 scratch of K*T + K*(C + 1) words a call)."""
    tile = lib.sorted_merge_tile()

    def merge(ak, av, keep, bk, bv, bc, out=None):
        K, n = ak.shape
        c = bk.shape[1]
        if out is None:
            out = (torch.empty_like(ak), torch.empty_like(av))
        scratch = torch.empty(K * -(-n // tile) + K * (c + 1),
                              dtype=torch.int32, device=ak.device)
        rc = lib.sorted_merge_launch(
            K, n, c, ak.data_ptr(), ak.stride(0), av.data_ptr(),
            av.stride(0), keep.data_ptr(), keep.stride(0), bk.data_ptr(),
            bk.stride(0), bv.data_ptr(), bv.stride(0), bc.data_ptr(),
            out[0].data_ptr(), out[0].stride(0), out[1].data_ptr(),
            out[1].stride(0), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent sorted_merge: error {rc}")
        return out
    return merge


def profiled_us(torch, cs, one, passes, key):
    """Device us a launch of the kernel named ``key`` over ``passes``
    profiled calls of ``one()`` (after 20 unprofiled ones)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            one()
        torch.cuda.synchronize()
    mine = [e for e in cs.device_rows(prof.key_averages())
            if key in e.key and "_kernel" in e.key]
    n = sum(e.count for e in mine)
    return sum(e.self_device_time_total for e in mine) / n if n else None


def merge_trace(torch, lib, traced, m_in, base):
    """One traced launch on each merge input (after one untraced): each
    phase's us over the tiles (median, largest), the span from the first
    CTA's start to the last one's end, and the pad CTAs' last end."""
    from repro_torch.kernels import _build, sorted_merge

    out = {}
    buf = np.zeros((1024, 8), np.int64)
    _build._lib = lib
    try:
        for mode, inp in m_in.items():
            for _ in range(2):
                sorted_merge.merge_compact_sharded(*inp)
                torch.cuda.synchronize()
            if traced.sorted_merge_trace(buf.ctypes.data):
                raise RuntimeError("sorted_merge_trace failed")
            used = buf[buf[:, 0] > 0]
            ns_per_clk = (used[:, 7] - used[:, 0]) / np.maximum(
                used[:, 6] - used[:, 1], 1)
            tiles = used[:, 3] > 0
            rec = {"ctas": int(len(used)), "span_us": float(
                (used[:, 7].max() - used[:, 0].min()) / 1e3),
                "pads_end_us": float(
                    (used[~tiles, 7].max() - used[:, 0].min()) / 1e3)
                if (~tiles).any() else None,
                "tiles_end_us": float(
                    (used[tiles, 7].max() - used[:, 0].min()) / 1e3),
                "start_spread_us": float(
                    (used[:, 0].max() - used[:, 0].min()) / 1e3)}
            for i, ph in enumerate(PHASES):
                d = (used[tiles, i + 2] - used[tiles, i + 1]) * \
                    ns_per_clk[tiles] / 1e3
                rec[f"{ph}_us"] = (float(np.median(d)), float(d.max()))
            out[mode] = rec
            print(f"trace {mode}: " + "; ".join(
                f"{k} {v}" for k, v in rec.items()))
    finally:
        _build._lib = base
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--passes", type=int, default=200)
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to run (default: "
                         "all)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kmin_merge_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import batched_pq as bpq
    from repro_torch.core import sharded_pq as spq
    from repro_torch.core.batched_map import ShardedMap
    from repro_torch.core.batched_sketch import ShardedSketch
    from repro_torch.kernels import _build, heap_kmin, sorted_merge

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    base = _build.library()
    nvcc = _build.nvcc_path()
    cufilt = str(Path(nvcc).parent / "cu++filt")
    libs, merges = {}, {}
    variants = sources(args.parent)
    if args.only:
        variants = {n: variants[n] for n in args.only.split(",")}
    for name, (path, log) in build(nvcc, _build.CFLAGS, variants).items():
        lib = ctypes.CDLL(str(path))
        entries = KMIN_ENTRIES + (
            ("sorted_merge_launch", "sorted_merge_tile") if name == "parent"
            else MERGE_ENTRIES)
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = (PARENT_MERGE if name == "parent" and entry
                           == "sorted_merge_launch" else
                           _build.SIGNATURES[entry])
            fn.restype = ctypes.c_int
        if name == "trace":
            lib.sorted_merge_trace.argtypes = [ctypes.c_void_p]
            lib.sorted_merge_trace.restype = ctypes.c_int
            traced = lib
        if name == "parent":
            libs[name] = Swapped(base, lib, KMIN_ENTRIES)
            merges[name] = parent_merge(torch, lib)
        else:
            libs[name] = Swapped(base, lib, KMIN_ENTRIES + MERGE_ENTRIES)
            merges[name] = sorted_merge.merge_compact_sharded
        print(f"{name}: " + "; ".join(
            f"{k} {r} regs, spills {st} / {ld}"
            for _, k, r, st, ld in cs.ptxas_report(log, cufilt)))

    dev = torch.device("cuda")
    cap1, cap4 = cs.pq_capacities(cs.N_KEYS, cs.THREADS, cs.OPS_PER_THREAD,
                                  cs.REPLAY_BATCHES)
    _, timed = cs.kernel_phase(torch, dev, args.seed, [(4, cap4)], 4)
    k_in, k_size, k_ne, k_c = timed["heap_kmin"]
    k_want = heap_kmin.k_smallest_plain(k_in, k_size, k_ne, k_c)
    map_cap = cs.shard_capacity(cs.MAP_KEYS + cs.THREADS * cs.MAP_OPS + 2, 4)
    rng = np.random.default_rng([args.seed, 14])
    m_in = {"fill": cs.merge_inputs(torch, dev, rng, 4, map_cap, cs.C_MAX,
                                    "few", cs.C_MAX, junk=False,
                                    fill=cs.MAP_KEYS // 4)}
    for mode in ("none", "empty"):
        m_in[mode] = cs.merge_inputs(torch, dev, rng, 4, map_cap, cs.C_MAX,
                                     mode, cs.C_MAX, junk=False,
                                     fill=cs.MAP_KEYS // 4)
    m_want = {k: sorted_merge.merge_compact_plain(*v) for k, v in
              m_in.items()}

    rng = np.random.default_rng([args.seed, 0])
    init = rng.uniform(0, cs.KEY_RANGE, cs.N_KEYS).astype(np.float32)
    total = cs.N_KEYS + 2 * (args.passes + 20) * 4 + 2
    queues = {
        "pq-single": lambda: bpq.BatchedPriorityQueue(
            cs.shard_capacity(total, 1), cs.C_MAX, values=init, device=dev),
        "pq-sharded": lambda: spq.ShardedBatchedPQ(
            cs.shard_capacity(total, 4), cs.C_MAX, n_shards=4, values=init,
            device=dev)}
    r = np.random.default_rng([args.seed, 20])
    keys = cs.grid_keys(r, cs.MAP_KEYS)
    vals = r.uniform(0, 10, cs.MAP_KEYS).astype(np.float32)
    scap = cs.shard_capacity(cs.MAP_KEYS + 2 * (args.passes + 20) + 400, 4)
    structs = {
        "map": (ShardedMap(scap, cs.C_MAX, n_shards=4,
                           key_range=cs.MAP_KEY_RANGE,
                           items=list(zip(keys.tolist(), vals.tolist())),
                           device=dev),
                lambda: ShardedMap(scap, cs.C_MAX, n_shards=4,
                                   key_range=cs.MAP_KEY_RANGE, device=dev),
                lambda q: cs.map_op(q, keys, cs.MAP_KEYS)),
        "sketch": (ShardedSketch(scap, cs.C_MAX, n_shards=4,
                                 topk_max=cs.TOPK_MAX,
                                 items=[(k, 5.0) for k in keys.tolist()],
                                 device=dev),
                   lambda: ShardedSketch(scap, cs.C_MAX, n_shards=4,
                                         topk_max=cs.TOPK_MAX, device=dev),
                   lambda q: cs.sketch_op(q, keys))}

    def kmin_situ(make):
        pq = make()
        q = np.random.default_rng([args.seed, 4])

        def one():
            ins = q.uniform(0, cs.KEY_RANGE, int(q.integers(0, 5)))
            pq.apply(int(q.integers(0, 5)), ins.astype(np.float32))
        return profiled_us(torch, cs, one, args.passes, "heap_kmin")

    def merge_situ(ds0, make, op, merge):
        ds = make()
        ds.state = type(ds0.state)(*(t.clone() for t in ds0.state))
        ds._refresh_sizes(ds0.state.size.cpu().numpy())
        ds._merge = merge
        q = np.random.default_rng([args.seed, 21])

        def draw(update):
            while True:
                mt, i = op(q)
                if (mt in ds.read_only) != update:
                    return mt, i

        def one():
            mt, i = draw(True)
            h = ds.update_batch_async([mt], [i])
            reads = [draw(False) for _ in range(3)]
            ds.read_batch([x for x, _ in reads], [y for _, y in reads])
            h.result()
        return profiled_us(torch, cs, one, args.passes, "sorted_merge")

    k_ring = [torch.empty_like(k_in) for _ in range(cs.RING)]
    zero = torch.zeros((2,) + tuple(m_in["fill"][0].shape),
                       dtype=torch.float32, device=dev)
    m_ring = [torch.empty_like(zero) for _ in range(cs.RING)]
    order = [v for v in libs if v != "trace"]
    rec = {v: {} for v in order}
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            _build._lib = libs[name]
            merge = merges[name]
            got = heap_kmin.k_smallest_sharded(k_in, k_size, k_ne, c_max=k_c)
            cs.check(all(torch.equal(g, w) for g, w in zip(got, k_want)),
                     f"{name}: heap_kmin != plain")
            for mode, inp in m_in.items():
                got = merge(*inp)
                cs.check(all(torch.equal(g.view(torch.int32),
                                         w.view(torch.int32))
                             for g, w in zip(got, m_want[mode])),
                         f"{name}: sorted_merge {mode} != plain")
            res = {"heap_kmin_cold_ms": cs._per_launch_ms(
                torch, lambda a: heap_kmin.k_smallest_sharded(
                    a, k_size, k_ne, c_max=k_c), k_ring, k_in, hold=True)}
            if name == "as_built":
                for ne in (1, 2, 4, 8):
                    res[f"heap_kmin_cold_ms_ne{ne}"] = cs._per_launch_ms(
                        torch, lambda a, ne=ne: heap_kmin.k_smallest_sharded(
                            a, k_size, ne, c_max=k_c), k_ring, k_in,
                        hold=True)
            for mode, inp in m_in.items():
                res[f"sorted_merge_{mode}_ms"] = cs._per_launch_ms(
                    torch, lambda o, inp=inp: merge(*inp, out=(o[0], o[1])),
                    m_ring, zero, hold=True)
            if name in ("as_built", "parent") or name.startswith("T"):
                for q, make in queues.items():
                    us = kmin_situ(make)
                    res[f"heap_kmin_in_situ_ms_{q}"] = (
                        us / 1e3 if us is not None else None)
                    torch.cuda.empty_cache()
            if not name.startswith("T"):
                for s, (ds0, make, op) in structs.items():
                    us = merge_situ(ds0, make, op, merge)
                    res[f"sorted_merge_in_situ_ms_{s}"] = (
                        us / 1e3 if us is not None else None)
            for key, val in res.items():
                rec[name].setdefault(key, []).append(val)
            _build._lib = base
    med = {}
    for name in order:
        med[name] = {k: (float(np.median(v)) if None not in v else None)
                     for k, v in rec[name].items()}
        print(f"{name} (median of {args.rounds} rounds): " + "; ".join(
            f"{k} {v:.6f}" if v is not None else f"{k} none"
            for k, v in med[name].items()))
    if "trace" in libs:
        med["trace"] = merge_trace(torch, libs["trace"], traced, m_in, base)
    print(json.dumps({"kmin_merge_ablation": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
