#!/usr/bin/env python3
"""Time the two backward scan kernels as built beside an earlier version of
them and beside other settings of their tiles, on one GPU.

    python3 tools/scan_bwd_ablation.py [--parent DIR] [--seed 0]
        [--rounds 3] [--only as_built,parent,...] [--kernels rwkv,rglru]
        [--diagnose]
    python3 tools/scan_bwd_ablation.py --train-steps 10 --parent DIR

Variants, each compiled with the package's ``nvcc`` flags from one copy of
``rwkv6_scan_bwd.cu`` and ``rglru_scan_bwd.cu`` into a library under
``build/scan_bwd_ablation/<variant>/``:

- ``as_built``: the sources as they are;
- ``parent``: ``DIR/src/repro_torch/kernels/csrc/{rwkv6,rglru}_scan_bwd.cu``
  with ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked
  from ``git archive`` under the ignored ``build/``); its ``rwkv6`` entry
  point takes the first design's scratch (a saved state every 64 steps
  and a chunk's 64 states a (batch, head)), which :func:`parent_rwkv6`
  allocates as that design's wrapper did;
- ``G<g>T<t>``: ``rwkv6_scan_bwd.cu`` with ``kG`` (CTAs a cluster, the
  row groups of a (batch, head)) = g and ``kT`` (steps a chunk) = t, over
  ``GROUPS`` x ``CHUNKS``; ``ops.BWD_CHUNK`` is set to t while it runs;
- ``T<t>N<n>``: ``rglru_scan_bwd.cu`` with ``kSteps`` (steps a stage) = t
  and ``kStages`` (stages in the ring) = n, over ``STEPS`` x ``STAGES``.

With ``--diagnose``, timing-only variants of ``rwkv6_scan_bwd.cu`` too,
each with one part of the kernel cut out (``DIAGNOSE``: the forward
sweep's steps, the pass that stores each sub-chunk's first state, the
backward sweep with its recomputation, dv's reduction over the cluster;
and the cluster barrier's arrive relaxed, bare or after a cluster-scope
fence), so the
time each part takes shows as the difference from ``as_built``; they
compute wrong gradients and are not held to the plain backward.

A variant whose settings equal the built ones is not built again, and one
whose shared memory passes a CTA's is skipped.  Each variant's entry
points stand in for the package's own (the other kernel's stay the
package's), and in every round each is first held to its plain backward
on the timed inputs: ``rglru_scan_bwd`` ``torch.equal`` to
``rglru_scan_bwd_plain``; ``rwkv6_scan_bwd`` within
``chip_smoke.BWD_NOISE_RATIO`` x the f32 plain backward's own error
against the plain backward in f64 (both computed once a shape).  Then it
is timed by ``chip_smoke.py``'s held CUDA-event windows at phase 23 (a)'s
shapes and at the train step's (2, 2,048): RWKV-6 3B's (4, 4,096, 40,
64), (8, 512, 40, 64), (2, 2,048, 40, 64) with bf16 r, k, v, and
RecurrentGemma-2B's (1, 8,192, 2,560), (8, 512, 2,560), (2, 2,048,
2,560); every working set is past the 50 MB L2 (cold).  Rounds visit the
variants in alternating order; the medians are printed beside the bounds
(``chip_smoke.bwd_bounds``), one JSON line last.

With ``--train-steps N``, instead: the train step end to end, the
parent's tree against this one.  In the order parent, this tree, this
tree, parent, one process a run, in that tree, runs the tree's own
``chip_smoke.train_runs`` for RWKV-6 3B and RecurrentGemma-2B at full
width and depth (``TRAIN_ROWS``: 2 x 2,048 tokens a step, N steps, then
one profiled step), and prints each run's step ms (median), tokens/s,
loss and the profiled step's device ms and hand-written kernels; one
JSON line last.  Exits 2 without a CUDA device.
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
OUT = ROOT / "build" / "scan_bwd_ablation"
FILES = {"rwkv": "rwkv6_scan_bwd.cu", "rglru": "rglru_scan_bwd.cu"}
ENTRIES = {"rwkv": ("rwkv6_scan_bwd_launch", "rwkv6_scan_bwd_smem_bytes"),
           "rglru": ("rglru_scan_bwd_launch", "rglru_scan_bwd_smem_bytes")}
GROUP_SET = "constexpr int kG = {};"
CHUNK_SET = "constexpr int kT = {};"
STEPS_SET = "constexpr int kSteps = {};"
STAGES_SET = "constexpr int kStages = {};"
GROUPS = (2, 4, 8)
CHUNKS = (16, 32)
STEPS = (16, 32, 64)
STAGES = (4, 6, 8)
SMEM_LIMIT = 232448               # bytes of shared memory a CTA can use
MAX_HEAD = 64
SHAPES = {"rwkv": {"scoring": (4, 4096, 40, 64), "prefill": (8, 512, 40, 64),
                   "train": (2, 2048, 40, 64)},
          "rglru": {"scoring": (1, 8192, 2560), "prefill": (8, 512, 2560),
                    "train": (2, 2048, 2560)}}
# --diagnose: (old, new) patches of rwkv6_scan_bwd.cu, each cutting out
# one part of the kernel (its loop runs no iteration)
DIAGNOSE = {
    "cut_forward": [("for (int u = 0; u < kT; ++u) fwd_step<T>(",
                     "for (int u = 0; u < 0; ++u) fwd_step<T>(")],
    "cut_subs": [("for (int m = 0; m < nsub; ++m) {",
                  "for (int m = 0; m < 0; ++m) {")],
    "cut_sweep": [("for (int m = nsub - 1; m >= 0; --m) {",
                   "for (int m = nsub - 1; m >= nsub; --m) {")],
    "cut_dv": [("i2 < kShare * (kHd / 4);", "i2 < 0;")],
    # the cluster barrier's arrive without its release (no ordering: the
    # dv sums may read stale tiles), and with a cluster-scope fence before
    # a relaxed arrive
    "arrive_relaxed": [("barrier.cluster.arrive.release.aligned;",
                        "barrier.cluster.arrive.relaxed.aligned;")],
    "fence_cluster": [("barrier.cluster.arrive.release.aligned;",
                       "fence.acq_rel.cluster; "
                       "barrier.cluster.arrive.relaxed.aligned;")],
}
TRAIN_ROWS = (("rwkv6_3b", 2, 2048), ("recurrentgemma_2b", 2, 2048))
# one run of a tree's chip_smoke.train_runs; {tree}, {seed}, {steps}
TRAIN_RUN = """
import json, sys
import torch
sys.path[:0] = [{tree!r} + "/src", {tree!r}]
import chip_smoke as cs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.linear_scan import (rglru_scan, rglru_scan_bwd,
                                             rwkv6_scan, rwkv6_scan_bwd)
counters = dict(flash_attention=flash_attention, rwkv6_scan=rwkv6_scan,
                rglru_scan=rglru_scan, rwkv6_scan_bwd=rwkv6_scan_bwd,
                rglru_scan_bwd=rglru_scan_bwd)
res = cs.train_runs(torch, torch.device("cuda"), {seed}, counters,
                    {rows!r}, {steps}, False, print)
keep = ("step_ms", "tokens_per_s", "first_loss", "final_loss",
        "max_memory_allocated")
print("RESULT " + json.dumps({{a: dict({{k: m[k] for k in keep}},
    device_ms=m["profile"]["device_ms"], busy=m["profile"]["busy_share"],
    ours=m["profile"]["ours"]) for a, m in res["models"].items()}}))
"""
PARENT_CHUNK = 64                 # the first design's saved-state interval
# the first design's rwkv6_scan_bwd_launch: 16 pointers (the saved states
# and the chunk's states last), B, S, H, hd, 9 strides, dtype, stream
PARENT_RWKV6 = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 \
    + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p]


def _setting(text, pattern):
    """The value of the one ``pattern`` (``...= {};``) line in ``text``."""
    rx = re.escape(pattern).replace(r"\{\}", r"(\d+)")
    found = re.findall(rx, text)
    if len(found) != 1:
        raise RuntimeError(f"{pattern.format('N')!r} not found once")
    return int(found[0])


def _patch(text, pattern, value):
    return text.replace(pattern.format(_setting(text, pattern)),
                        pattern.format(value))


def rwkv_smem(g, t):
    """rwkv6_scan_bwd.cu's Slot<bf16>::kSmem at kG = g, kT = t (the
    source's formula): two ring stages (the saved state, dy and v in f32,
    w, r and k, v as staged), the first state of each 8-step sub-chunk,
    dv's two tiles of sums a warp, v . dy a warp, u."""
    rows, warps = MAX_HEAD // g, MAX_HEAD // g // 4
    slot = 4 * rows * MAX_HEAD + 8 * t * MAX_HEAD + 4 * t * rows \
        + 4 * t * rows + 2 * t * MAX_HEAD
    return 2 * slot + 4 * (t // 8 * rows * MAX_HEAD
                           + 2 * t * warps * MAX_HEAD + warps * t + rows)


def rglru_smem(steps, stages):
    """rglru_scan_bwd.cu's kSmemBytes: the barriers, three input arrays a
    stage and two output stages of two arrays."""
    return 16 * (stages + 2) + 4 * (3 * stages + 4) * steps * 32


def patched(text, patches):
    """``text`` with each (old, new) of ``patches`` applied, each old
    found exactly once."""
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old!r}")
        text = text.replace(old, new)
    return text


def sources(parent, kinds, diagnose=False):
    """variant -> {kind: source text}; a variant holds the kinds it
    changes (the parent both)."""
    built = {kind: (CSRC / FILES[kind]).read_text() for kind in kinds}
    out = {"as_built": dict(built)}
    if parent is not None:
        out["parent"] = {kind: (Path(parent) / "src" / "repro_torch" /
                                "kernels" / "csrc" / FILES[kind]).read_text()
                         for kind in kinds}
    if "rwkv" in kinds:
        text = built["rwkv"]
        for g in GROUPS:
            for t in CHUNKS:
                v = _patch(_patch(text, GROUP_SET, g), CHUNK_SET, t)
                if (v != text and t % g == 0 and t % 8 == 0
                        and rwkv_smem(g, t) <= SMEM_LIMIT):
                    out[f"G{g}T{t}"] = {"rwkv": v}
        if diagnose:
            for name, patches in DIAGNOSE.items():
                out[name] = {"rwkv": patched(text, patches)}
    if "rglru" in kinds:
        text = built["rglru"]
        for t in STEPS:
            for n in STAGES:
                v = _patch(_patch(text, STEPS_SET, t), STAGES_SET, n)
                if v != text and rglru_smem(t, n) <= SMEM_LIMIT:
                    out[f"T{t}N{n}"] = {"rglru": v}
    return out


def build(nvcc, cflags, variants):
    """Compile every variant's sources at once, one library a variant;
    return name -> (library path, ptxas log)."""
    procs = {}
    for name, texts in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        paths = []
        for kind, text in texts.items():
            (d / FILES[kind]).write_text(text)
            paths.append(str(d / FILES[kind]))
        procs[name] = subprocess.Popen(
            [nvcc, *cflags, "-Xptxas", "-v", "-shared", "-o",
             str(d / "libscanbwd.so"), *paths],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (OUT / name / "libscanbwd.so", log)
    return out


class Swapped:
    """The package's library with some entry points of a variant."""

    def __init__(self, base, variant, entries):
        self._base, self._variant, self._entries = base, variant, entries

    def __getattr__(self, name):
        return getattr(self._variant if name in self._entries else
                       self._base, name)


def parent_rwkv6(torch, lib, ops, r, k, v, w, u, state0, dy, dsT):
    """One launch of the first design's ``rwkv6_scan_bwd`` (``lib``'s),
    with its scratch as its wrapper allocated it: a saved state every 64
    steps and a chunk's 64 states, 16 KB each, a (batch, head)."""
    from repro_torch.kernels import _build

    dev = r.device
    B, S, H, hd = r.shape
    grads = [torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
             for _ in range(4)]
    du = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    saved = torch.empty((B * H, max(-(-S // PARENT_CHUNK), 1),
                         MAX_HEAD * MAX_HEAD), dtype=torch.float32,
                        device=dev)
    states = torch.empty((B * H, PARENT_CHUNK, MAX_HEAD * MAX_HEAD),
                         dtype=torch.float32, device=dev)
    rc = lib.rwkv6_scan_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), state0.data_ptr(), dy.data_ptr(), dsT.data_ptr(),
        *(g.data_ptr() for g in grads), du.data_ptr(), ds0.data_ptr(),
        saved.data_ptr(), states.data_ptr(), B, S, H, hd,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        ops._DTYPES[r.dtype], _build.stream(dev))
    _build.check(rc, "parent rwkv6_scan_bwd")
    return (*grads, du.sum(0), ds0)


def train_steps(parent, seed, steps):
    """``--train-steps``: the train rows of each tree, parent and this one
    in turns, one process a run."""
    trees = {"parent": str(Path(parent).resolve()), "this": str(ROOT)}
    runs = {"parent": [], "this": []}
    for name in ("parent", "this", "this", "parent"):
        code = TRAIN_RUN.format(tree=trees[name], seed=seed, steps=steps,
                                rows=TRAIN_ROWS)
        p = subprocess.run([sys.executable, "-c", code], cwd=trees[name],
                           capture_output=True, text=True)
        lines = p.stdout.splitlines()
        for line in lines:
            if line.startswith("train: "):
                print(f"{name}: {line}")
        if p.returncode:
            raise RuntimeError(f"{name} run failed:\n{p.stdout[-4000:]}"
                               f"\n{p.stderr[-4000:]}")
        runs[name].append(json.loads(lines[-1][len("RESULT "):]))
    for arch, _, _ in TRAIN_ROWS:
        for name in runs:
            ms = [r[arch]["step_ms"] for r in runs[name]]
            ours = "; ".join(f"{k} {v[0]:.3f} ms x {v[1]}" for k, v in
                             runs[name][0][arch]["ours"].items())
            print(f"{arch} {name}: step ms {ms} (tokens/s "
                  f"{[round(r[arch]['tokens_per_s'], 1) for r in runs[name]]}"
                  f"), profiled step device ms "
                  f"{[round(r[arch]['device_ms'], 3) for r in runs[name]]}, "
                  f"first run's hand-written kernels: {ours}")
    print(json.dumps({"scan_bwd_train": runs}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to run (default: "
                         "all)")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="time the train step of RWKV-6 3B and "
                         "RecurrentGemma-2B over this many steps, parent "
                         "(--parent) against this tree, instead")
    ap.add_argument("--diagnose", action="store_true",
                    help="also time rwkv6_scan_bwd with each of its parts "
                         "cut out (not held to the plain backward)")
    ap.add_argument("--kernels", default="rwkv,rglru",
                    help="comma-separated kernels to vary and time: rwkv, "
                         "rglru (default both)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.linear_scan import ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    if args.train_steps:
        if args.parent is None:
            ap.error("--train-steps needs --parent")
        return train_steps(args.parent, args.seed, args.train_steps)
    kinds = args.kernels.split(",")
    base = _build.library()
    nvcc = _build.nvcc_path()
    cufilt = str(Path(nvcc).parent / "cu++filt")
    variants = sources(args.parent, kinds, args.diagnose)
    if args.only:
        variants = {n: variants[n] for n in args.only.split(",")}
    libs, chunk = {}, {}
    for name, (path, log) in build(nvcc, _build.CFLAGS, variants).items():
        lib = ctypes.CDLL(str(path))
        entries = set()
        for kind in variants[name]:
            for entry in ENTRIES[kind]:
                if name == "parent" and entry.endswith("smem_bytes") \
                        and not hasattr(lib, entry):
                    continue
                fn = getattr(lib, entry)
                fn.argtypes = (PARENT_RWKV6 if name == "parent" and
                               entry == "rwkv6_scan_bwd_launch" else
                               _build.SIGNATURES[entry])
                fn.restype = ctypes.c_int
                entries.add(entry)
        libs[name] = Swapped(base, lib, entries)
        if "rwkv" in variants[name] and name != "parent":
            chunk[name] = _setting(variants[name]["rwkv"], CHUNK_SET)
        smem = "; ".join(f"{e} {getattr(lib, e)()}" for e in sorted(entries)
                         if e.endswith("smem_bytes"))
        print(f"{name}: " + "; ".join(
            f"{k} {r} regs, spills {st} / {ld}"
            for _, k, r, st, ld in cs.ptxas_report(log, cufilt)
            if "scan_bwd" in k) + (f"; shared memory a CTA: {smem}"
                                   if smem else ""))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    inputs, wants, bounds = {}, {}, {}
    if "rwkv" in kinds:
        for label, (B, S, H, hd) in SHAPES["rwkv"].items():
            shape = (B, S, H, hd)
            ins = (*(randn(*shape).to(torch.bfloat16) for _ in range(3)),
                   torch.exp(-torch.exp(rand(*shape) * 8.0 - 6.0)),
                   randn(H, hd), randn(B, H, hd, hd), randn(*shape),
                   randn(B, H, hd, hd))
            p64 = ops.rwkv6_scan_bwd_plain(*(x.double() for x in ins))
            noise = cs._grads_rel(torch, ops.rwkv6_scan_bwd_plain(*ins),
                                  p64)
            inputs[("rwkv", label)] = ins
            wants[("rwkv", label)] = (p64, noise)
            bounds[f"rwkv_{label}"] = cs.bwd_bounds("rwkv6_scan_bwd", shape,
                                                    2)[0]
    if "rglru" in kinds:
        for label, (B, S, R) in SHAPES["rglru"].items():
            a = torch.exp(-torch.exp(rand(B, S, R) * 10.0 - 7.0))
            hs, _ = ops.rglru_scan(a, randn(B, S, R), randn(B, R))
            ins = (a, randn(B, R), hs, randn(B, S, R), randn(B, R))
            inputs[("rglru", label)] = ins
            wants[("rglru", label)] = ops.rglru_scan_bwd_plain(*ins)
            bounds[f"rglru_{label}"] = cs.bwd_bounds("rglru_scan_bwd",
                                                     (B, S, R), 4)[0]
    order = list(libs)
    rec = {v: {} for v in order}
    default_chunk = ops.BWD_CHUNK
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            _build._lib = libs[name]
            ops.BWD_CHUNK = chunk.get(name, default_chunk)
            try:
                for (kind, label), ins in inputs.items():
                    if kind not in variants[name]:
                        continue
                    if kind == "rwkv":
                        fn = (lambda ins=ins: parent_rwkv6(
                            torch, libs[name], ops, *ins)) \
                            if name == "parent" else \
                            (lambda ins=ins: ops.rwkv6_scan_bwd(*ins))
                        p64, noise = wants[(kind, label)]
                        err = cs._grads_rel(torch, fn(), p64)
                        cs.check(name in DIAGNOSE or
                                 err <= cs.BWD_NOISE_RATIO * noise,
                                 f"{name}: rwkv6_scan_bwd {label} "
                                 f"{err:.3e} off f64 (f32 plain "
                                 f"{noise:.3e})")
                    else:
                        def fn(ins=ins):
                            return ops.rglru_scan_bwd(*ins)
                        cs.check(all(torch.equal(g, w) for g, w in zip(
                            fn(), wants[(kind, label)])),
                            f"{name}: rglru_scan_bwd {label} != plain")
                    ms = cs._per_call_ms(torch, fn, 3, 5, hold=True)
                    rec[name].setdefault(f"{kind}_{label}_ms",
                                         []).append(ms)
            finally:
                _build._lib = base
                ops.BWD_CHUNK = default_chunk
    med = {}
    for name in order:
        med[name] = {k: float(np.median(v)) for k, v in rec[name].items()}
        print(f"{name} (median of {args.rounds} rounds): " + "; ".join(
            f"{k} {v:.6f} (bound {bounds[k[:-3]]:.6f})"
            for k, v in med[name].items()))
    print(json.dumps({"scan_bwd_ablation": med, "bound_ms": bounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
