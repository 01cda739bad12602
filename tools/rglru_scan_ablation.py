#!/usr/bin/env python3
"""Time ``rglru_scan`` as built beside an earlier version of it and beside
other settings of its ring, on one GPU.

    python3 tools/rglru_scan_ablation.py [--parent DIR] [--seed 0]
        [--rounds 3] [--only as_built,parent,...]

Variants, each compiled with the package's ``nvcc`` flags from one copy of
``rglru_scan.cu`` into a library under ``build/rglru_scan_ablation/<variant>/``:

- ``as_built``: the source as it is;
- ``parent``: ``DIR/src/repro_torch/kernels/csrc/rglru_scan.cu`` with
  ``--parent DIR`` (a checkout of the commit before the redesign, e.g.
  unpacked from ``git archive``; its entry point takes the same
  arguments);
- ``C<c>``: ``kChannels`` (channels a CTA) = c, for c in ``CHANNELS``;
- ``T<t>N<n>``: ``kSteps`` (steps a stage) = t and ``kStages`` (stages in
  the ring) = n, over ``STEPS`` x ``STAGES``;
- ``regs_store``: each h stored to hs from the chain's register by the
  chain's warp (no storer warp, no output stages);
- ``bulk_store``: the storer warp writes each output stage back by one
  ``cp.async.bulk`` shared-to-global copy a row in place of 16-byte
  stores;
- ``bulk_load``: a and b staged by one ``cp.async.bulk`` a row on the full
  barrier's transaction count in place of 16-byte ``cp.async`` copies.

The last three are paths the kernel does not build; each is a list of
textual patches of the source (``PATCHES``), each applying exactly once.
A variant whose settings equal the built ones is not built again, and one
whose ring does not fit a CTA's shared memory is skipped.  Each variant's
entry point stands in for the package's own, and in every round each is
first held ``torch.equal`` to ``rglru_scan_plain`` at RecurrentGemma's
scoring (1, 8,192, 2,560) and serving prefill (8, 512, 2,560) shapes and
on views one element into their storage (4-byte copies), then timed at
both shapes by ``chip_smoke.py``'s held CUDA-event windows (a working set
of 252 MB and 126 MB, past the 50 MB L2: cold).  ``as_built`` and
``parent`` are also timed on the scoring shape's bytes cut into B = 2, 4
and 8 batches of shorter chains (``CHAINS``: how much of the time is the
chain), and each round times one ``torch.add(a, b)`` over the scoring
shape's a and b as a yardstick of what a streaming kernel gets from this
card's memory for the same bytes (not the same function: no PyTorch call
computes the recurrence).  Rounds visit the variants in alternating
order; the medians are printed beside the byte bounds, one JSON line
last.  Exits 2 without a CUDA device.
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
OUT = ROOT / "build" / "rglru_scan_ablation"
FILE = "rglru_scan.cu"
ENTRIES = ("rglru_scan_launch", "rglru_scan_smem_bytes")
CHANNELS_SET = "constexpr int kChannels = {}; "
STEPS_SET = "constexpr int kSteps = {}; "
STAGES_SET = "constexpr int kStages = {}; "
OUT_STAGES_SET = "constexpr int kOutStages = {}; "
CHANNELS = (8, 16, 20, 24, 32)
STEPS = (32, 64, 128)
STAGES = (4, 6, 8)
SMEM_LIMIT = 232448               # bytes of shared memory a CTA can use
SHAPES = {"scoring": (1, 8192, 2560), "prefill": (8, 512, 2560)}
# the scoring shape's bytes with shorter chains: batches of 8,192 / B steps
CHAINS = (2, 4, 8)

REGS_STORE = [  # the chain's warp stores each h; no storer, no out stages
    ("constexpr int kThreads = 96;", "constexpr int kThreads = 64;"),
    ("constexpr int kOutStages = 2;", "constexpr int kOutStages = 0;"),
    ("""                                           float* out, uint32_t empty, int nt,
""", """                                           float* out, long long ostride,
                                           uint32_t empty, int nt,
"""),
    ("if (live) out[t * kChannels + cl] = h;",
     "if (live) out[t * ostride + cl] = h;"),
    ("""    wait(out_empty + 8 * o, ((s >> 1) & 1) ^ 1);
""", ""),
    ("""    float* out = outs + o * kStage;
    if (nt == kSteps)""", """    float* out = p.hs + bi * p.S * p.R + c0 + t0 * (long long)p.R;
    if (nt == kSteps)"""),
    ("run_stage<true>(sa, sa + kStage, out, empty",
     "run_stage<true>(sa, sa + kStage, out, p.R, empty"),
    ("run_stage<false>(sa, sa + kStage, out, empty",
     "run_stage<false>(sa, sa + kStage, out, p.R, empty"),
    ("""    arrive(out_full + 8 * o);
""", ""),
]
HELPERS_AT = "// f(u, q, bytes) for this lane's 16-byte pieces"
BULK_STORE = [  # the storer's write-back by one bulk copy a row
    (HELPERS_AT, """__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

""" + HELPERS_AT),
    ("""    if (p.vec_out) {
      for_pieces(nt, nc, lane, [&](int u, int q, int) {
        *reinterpret_cast<float4*>(row + u * R + q) =
            *reinterpret_cast<const float4*>(out + u * kChannels + q);
      });
    } else {""", """    if (p.vec_out) {
      for (int u = lane; u < nt; u += 32)
        bulk_store(row + u * R, smem(out + u * kChannels), nc * 4);
      asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
    } else {"""),
    ("""    arrive(out_empty + 8 * o);
  }
}""", """    arrive(out_empty + 8 * o);
  }
  asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");
}"""),
    # the bulk copies read the output stage through the async proxy
    ("""    arrive(out_full + 8 * o);
""", """    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    arrive(out_full + 8 * o);
"""),
]
BULK_LOAD = [  # a and b by one bulk copy a row on the transaction count
    (HELPERS_AT, """__device__ __forceinline__ void arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

""" + HELPERS_AT),
    ("""  const long long steps[2] = {p.as, p.bs};
""", """  const long long steps[2] = {p.as, p.bs};
  const bool bulk = p.vec_in && nc % 4 == 0;
"""),
    ("""      if (p.vec_in) {
        for_pieces(""", """      if (bulk) {
        if (k == 0 && lane == 0) arrive_expect(bar, 2u * nt * nc * 4);
        __syncwarp();
        for (int u = lane; u < nt; u += 32)
          bulk_load(dst + 4 * u * kChannels, src + u * st, nc * 4, bar);
      } else if (p.vec_in) {
        for_pieces("""),
    ("""    arrive_on_copies(bar);
""", """    if (!bulk)
      arrive_on_copies(bar);
    else if (lane != 0)
      arrive(bar);
"""),
]
PATCHES = {"regs_store": REGS_STORE, "bulk_store": BULK_STORE,
           "bulk_load": BULK_LOAD}


def _setting(text, pattern):
    """The value of the one ``pattern`` (``...= {}; ``) line in ``text``."""
    rx = re.escape(pattern).replace(r"\{\}", r"(\d+)")
    found = re.findall(rx, text)
    if len(found) != 1:
        raise RuntimeError(f"{pattern.format('N')!r} not found once")
    return int(found[0])


def _patch(text, pattern, value):
    return text.replace(pattern.format(_setting(text, pattern)),
                        pattern.format(value))


def patched(text, patches):
    """``text`` with each (old, new) of ``patches`` applied, each old
    found exactly once."""
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old!r}")
        text = text.replace(old, new)
    return text


def smem_bytes(text):
    """The variant's dynamic shared memory, as the source computes it."""
    c, t, n = (_setting(text, p) for p in (CHANNELS_SET, STEPS_SET,
                                            STAGES_SET))
    outs = _setting(text, OUT_STAGES_SET)
    return 16 * (n + outs) + 4 * (2 * n + outs) * t * c


def sources(parent):
    """variant -> source text (variants equal to the built one, and those
    past a CTA's shared memory, left out)."""
    built = (CSRC / FILE).read_text()
    out = {"as_built": built}
    if parent is not None:
        out["parent"] = (Path(parent) / "src" / "repro_torch" / "kernels" /
                         "csrc" / FILE).read_text()
    cands = {f"C{c}": _patch(built, CHANNELS_SET, c) for c in CHANNELS}
    cands.update({f"T{t}N{n}": _patch(_patch(built, STEPS_SET, t),
                                      STAGES_SET, n)
                  for t in STEPS for n in STAGES})
    cands.update({name: patched(built, patches)
                  for name, patches in PATCHES.items()})
    for name, text in cands.items():
        if text != built and smem_bytes(text) <= SMEM_LIMIT:
            out[name] = text
    return out


def build(nvcc, cflags, variants):
    """Compile every variant at once; return name -> (library, ptxas log)."""
    procs = {}
    for name, text in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / FILE).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cflags, "-Xptxas", "-v", "-shared", "-o",
             str(d / "librglru.so"), str(d / FILE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (OUT / name / "librglru.so", log)
    return out


class Swapped:
    """The package's library with some entry points of a variant."""

    def __init__(self, base, variant, entries):
        self._base, self._variant, self._entries = base, variant, entries

    def __getattr__(self, name):
        return getattr(self._variant if name in self._entries else
                       self._base, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to run (default: "
                         "all)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("rglru_scan_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.linear_scan import rglru_scan, rglru_scan_plain

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    base = _build.library()
    nvcc = _build.nvcc_path()
    cufilt = str(Path(nvcc).parent / "cu++filt")
    variants = sources(args.parent)
    if args.only:
        variants = {n: variants[n] for n in args.only.split(",")}
    libs = {}
    for name, (path, log) in build(nvcc, _build.CFLAGS, variants).items():
        lib = ctypes.CDLL(str(path))
        entries = ENTRIES[:1] if name == "parent" else ENTRIES
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = Swapped(base, lib, entries)
        smem = (f"{lib.rglru_scan_smem_bytes()} bytes of dynamic shared "
                f"memory" if name != "parent" else "")
        print(f"{name}: " + "; ".join(
            f"{k} {r} regs, spills {st} / {ld}"
            for _, k, r, st, ld in cs.ptxas_report(log, cufilt)
            if "rglru" in k) + (f"; {smem}" if smem else ""))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    inputs, wants = {}, {}
    for label, shape in SHAPES.items():
        a = torch.rand(shape, generator=gen, device=dev) * 0.8 + 0.2
        b = torch.randn(shape, generator=gen, device=dev)
        h0 = torch.randn(shape[::2], generator=gen, device=dev)
        inputs[label] = (a, b, h0)
        wants[label] = rglru_scan_plain(a, b, h0)
    a, b, h0 = inputs["prefill"]
    inputs["offset"] = (cs._offset_view(torch, a[:, :77]),
                        cs._offset_view(torch, b[:, :77]), h0)
    wants["offset"] = rglru_scan_plain(*inputs["offset"])
    B1, S1, R1 = SHAPES["scoring"]
    timed = dict(SHAPES)
    for B in CHAINS:
        timed[f"chain{S1 // B}"] = shape = (B, S1 // B, R1)
        inputs[f"chain{S1 // B}"] = (
            torch.rand(shape, generator=gen, device=dev) * 0.8 + 0.2,
            torch.randn(shape, generator=gen, device=dev),
            torch.randn((B, R1), generator=gen, device=dev))
        wants[f"chain{S1 // B}"] = rglru_scan_plain(*inputs[f"chain{S1 // B}"])
    bounds = {label: cs.scan_bounds("rglru_scan", shape, 4)[0]
              for label, shape in timed.items()}
    a, b, _ = inputs["scoring"]
    out = torch.empty_like(a)
    order = list(libs)
    rec = {v: {} for v in order}
    stream = []
    for rnd in range(args.rounds):
        # the yardstick: one streaming add over the scoring shape's bytes
        stream.append(cs._per_call_ms(
            torch, lambda: torch.add(a, b, out=out), 10, 5, hold=True))
        for name in (order if rnd % 2 == 0 else order[::-1]):
            _build._lib = libs[name]
            try:
                for label, inp in inputs.items():
                    hs, hT = rglru_scan(*inp)
                    ws, wT = wants[label]
                    cs.check(torch.equal(hs, ws) and torch.equal(hT, wT),
                             f"{name}: rglru_scan {label} != plain")
                for label in (timed if name in ("as_built", "parent")
                              else SHAPES):
                    inp = inputs[label]
                    ms = cs._per_call_ms(torch, lambda: rglru_scan(*inp),
                                         10, 5, hold=True)
                    rec[name].setdefault(f"{label}_ms", []).append(ms)
            finally:
                _build._lib = base
    med = {}
    for name in order:
        med[name] = {k: float(np.median(v)) for k, v in rec[name].items()}
        print(f"{name} (median of {args.rounds} rounds): " + "; ".join(
            f"{k} {v:.6f} (bound {bounds[k[:-3]]:.6f})"
            for k, v in med[name].items()))
    med["stream_add_ms"] = float(np.median(stream))
    print(f"torch.add(a, b) over the scoring shape's bytes (median of "
          f"{args.rounds}): {med['stream_add_ms']:.6f} ms")
    print(json.dumps({"rglru_scan_ablation": med, "bound_ms": bounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
