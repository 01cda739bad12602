#!/usr/bin/env python3
"""Time the contracted-merge body of ``label_prop.cu`` with and without
each of its two latency measures, on one GPU.

    python3 tools/label_prop_merge_ablation.py [--seed 0] [--rounds 4]

The merge body (``label_prop_merge_kernel``) loads each thread's first
``kMergeVec`` vectors of the labels before its grid barrier ("preload"),
and tests a 16,384-bit filter before it searches the table ("filter").
This script builds four copies of ``src/repro_torch/kernels/csrc/
label_prop.cu`` -- as it is, without the preload (the same vectors loaded
after the barrier), without the filter (every label searched), and
without both -- each patched in text and compiled with the package's
``nvcc`` flags into ``build/label_prop_ablation/<variant>/``.  On the
graph's tree buffer at 1,000,000 vertices (``chip_smoke.py``'s inputs,
from ``--seed``) it holds every variant's merge bit-equal to
``propagate_plain`` at the graph's pending shape (33 slots, 32 live) and
at 16 unions, then prints each variant's per-launch ms at both shapes
(``chip_smoke.py``'s held CUDA-event windows), median over ``--rounds``
rounds that visit the variants in alternating order, with the package's
own ``propagate`` timed in the same rounds beside them.  Exits 2 without
a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "label_prop.cu"
OUT = ROOT / "build" / "label_prop_ablation"

PRELOAD = [  # the preloaded vectors become loads after the barrier
    ("""  int4 pre[kMergeVec];
#pragma unroll
  for (int j = 0; j < kMergeVec; ++j) {
    const int k = tid + j * stride;
    pre[j] = k < n4 ? io4[k] : make_int4(0, 0, 0, 0);
  }
""", ""),
    ("if (k < n4) rewrite4(t, io4, k, pre[j]);",
     "if (k < n4) rewrite4(t, io4, k, io4[k]);"),
]
FILTER = [  # no filter is built or tested: every label is searched
    ("""  const unsigned h = filter_hash(x);
  if (!((t.filter[h >> 5] >> (h & 31)) & 1u)) return x;
""", ""),
    ("""  for (int w = i; w < kFilterWords; w += blockDim.x) t.filter[w] = 0;
""", ""),
    ("""    if (changed) {
      const unsigned h = filter_hash(t.sorted[i]);
      atomicOr(&t.filter[h >> 5], 1u << (h & 31));
    }
""", ""),
]
VARIANTS = {"as_built": [], "no_preload": PRELOAD, "no_filter": FILTER,
            "neither": PRELOAD + FILTER}


def patched(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(nvcc: str, cflags) -> dict:
    """Compile every variant at once; return name -> (library path, ptxas
    log)."""
    src = CU.read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        cu = d / "label_prop.cu"
        cu.write_text(patched(src, patches))
        procs[name] = subprocess.Popen(
            [nvcc, *cflags, "-Xptxas", "-v", "-shared", "-o",
             str(d / "liblabel_prop.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        built[name] = (OUT / name / "liblabel_prop.so", log)
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("label_prop_merge_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.label_prop.ops import (BODIES, MAX_ITERS,
                                                    propagate,
                                                    propagate_plain)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    nvcc = _build.nvcc_path()
    cufilt = str(Path(nvcc).parent / "cu++filt")
    libs = {}
    for name, (path, log) in build_variants(nvcc, _build.CFLAGS).items():
        lib = ctypes.CDLL(str(path))
        lib.label_prop_launch.argtypes = _build.SIGNATURES[
            "label_prop_launch"]
        lib.label_prop_launch.restype = ctypes.c_int
        libs[name] = lib
        print(f"{name}: " + "; ".join(
            f"{k} {r} regs, spills {st} / {ld}"
            for _, k, r, st, ld in cs.ptxas_report(log, cufilt)
            if "merge" in k))

    dev = torch.device("cuda")
    n = cs.GRAPH_VERTICES
    _, eu, ev, kw = cs.label_prop_cases(torch, dev, args.seed, n)[0]
    base = torch.empty(n, dtype=torch.int32, device=dev)
    propagate_plain(eu, ev, base, **kw)
    rng = np.random.default_rng([args.seed, 8])
    tu, tv = cs.random_tree(np.random.default_rng([args.seed, 7]), n)
    width, k = 2 * cs.C_MAX + 1, 2 * cs.C_MAX
    pick = rng.integers(0, n - 1, width)
    pend = np.stack([rng.integers(0, n, width),
                     rng.integers(0, n, width)]).astype(np.int32)
    pend[0, :k], pend[1, :k] = tu[pick[:k]], tv[pick[:k]]
    pend = torch.from_numpy(pend).to(dev)
    u = rng.integers(0, n, cs.C_MAX)
    v = np.where(rng.random(cs.C_MAX) < 0.5, (u + 1) % n,
                 rng.integers(0, n, cs.C_MAX))
    no = torch.zeros((), dtype=torch.bool, device=dev)
    shapes = {
        "merge_33": (pend[0], pend[1], dict(
            e_live=torch.full((), k, dtype=torch.int32, device=dev),
            unless=no)),
        "unions_16": (torch.from_numpy(u.astype(np.int32)).to(dev),
                      torch.from_numpy(v.astype(np.int32)).to(dev), {}),
    }
    scratch = torch.empty(1, dtype=torch.int32, device=dev)
    ctrl = torch.empty(4, dtype=torch.int32, device=dev)

    def launcher(lib, pu, pv, kw):
        def ptr(t):
            return None if t is None else t.data_ptr()

        def fn(r):
            _build.check(lib.label_prop_launch(
                BODIES["merge"], n, pu.data_ptr(), pv.data_ptr(), pu.numel(),
                None, ptr(kw.get("e_live")), None, 1, None,
                ptr(kw.get("unless")), r.data_ptr(), scratch.data_ptr(),
                ctrl.data_ptr(), MAX_ITERS, _build.stream(dev)),
                "label_prop_merge_ablation")
        return fn

    fns = {}
    for shape, (pu, pv, kw) in shapes.items():
        want = base.clone()
        propagate_plain(pu, pv, want, relabel=True, **kw)
        changed = int((want != base).sum())
        print(f"{shape}: {pu.numel()} slots, {changed} labels changed")
        fns[shape, "propagate"] = (
            lambda pu, pv, kw: lambda r: propagate(pu, pv, r, relabel=True,
                                                   **kw))(pu, pv, kw)
        for name, lib in libs.items():
            fn = launcher(lib, pu, pv, kw)
            for _ in range(3):
                got = base.clone()
                fn(got)
                cs.check(int(ctrl[0]) == 1 and torch.equal(got, want),
                         f"{name} at {shape}: merge != plain")
            fns[shape, name] = fn
    ring = [torch.empty_like(base) for _ in range(cs.RING)]
    order = ["propagate", *VARIANTS]
    times = {key: [] for key in fns}
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            for shape in shapes:
                times[shape, name].append(cs._per_launch_ms(
                    torch, fns[shape, name], ring, base, hold=True))
    rec = {shape: {name: float(np.median(times[shape, name]))
                   for name in order} for shape in shapes}
    for shape in shapes:
        print(f"{shape} ms (median of {args.rounds} rounds): " + "; ".join(
            f"{name} {rec[shape][name]:.6f}" for name in order))
    print(json.dumps({"label_prop_merge_ablation": rec,
                      "rounds": {f"{s}/{m}": t for (s, m), t in
                                 times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
