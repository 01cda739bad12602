"""CPU emulation of the Hopper design of ``rglru_scan.cu``, held to the
plain version, the exact scan and the JAX function.

The CUDA kernel cannot run here, so its schedule is replayed in numpy the
way the kernel runs it.  Each CTA owns C channels of one batch row and
three warps, emulated as coroutines:

- the producer fills a ring of N shared-memory stages of T steps of a and
  b, each stage once its empty barrier has passed, by 16-byte copies (the
  kernel's ``for_pieces``: fixed pieces a lane, whole rows an instruction,
  for a full tile, else index arithmetic, a partial piece ending a row of
  nc % 4 != 0 channels) or, for rows that are not 16-byte aligned
  (``ops.rglru_rows_aligned``), 4-byte copies; each lane then arrives on
  the stage's full barrier once its own copies have landed
  (``cp.async.mbarrier.arrive.noinc``);
- the consumer waits on the full barrier, reads the stage kSub = min(32,
  T) steps at a time, arrives on the empty barrier after the last read,
  and runs the chain, a rounded product then a rounded sum a step, into
  one of two output stages (its own full/empty pair);
- the storer writes each output stage back to hs by 16-byte pieces (rows
  of R % 4 == 0) or element by element, then releases it.

Copies are in flight until a memory coroutine lands them, one at a time in
random order.  A seeded scheduler steps the coroutines of every CTA and the
memory in shuffled order, within what the barriers allow; a barrier is an
mbarrier (a count of arrivals completes a phase; a wait on parity P passes
while the number of completed phases is not P mod 2).  Checked on every
run: every stage slot is read only after the stage's own copies have all
landed in it, and refilled only after the consumer released its previous
stage; each output stage likewise; every copy reads inside the source's
(S, R) rows; each stage's pieces cover its tile exactly once; every hs
element is written exactly once.  hs and hT are ``torch.equal`` to
``rglru_scan_plain`` and to ``rglru_reference``, and within atol 1e-5 of
the JAX ``rglru_scan`` (the Pallas kernel in interpret mode; XLA contracts
a·h + b into an FMA, as ``test_torch_linear_scan.py`` holds it).  With
the producer's wait on the empty barrier skipped, some seed gives a wrong
hs.

The tile (C, T, N) and the alignment rule are read from
``kernels/linear_scan/ops.py``'s mirror, which is held equal to the
kernel source's constants here.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import rglru_scan as jax_rglru
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.linear_scan import rglru_scan_plain
from repro_torch.kernels.linear_scan.ref import rglru_reference

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
WARP = 32
C_BUILT = scan_ops.RGLRU_CHANNELS
T_BUILT = scan_ops.RGLRU_STEPS
N_BUILT = scan_ops.RGLRU_STAGES


def _source_int(name):
    found = re.findall(rf"\b{name} = (\d+)[,;]",
                       (CSRC / "rglru_scan.cu").read_text())
    assert len(found) == 1, name
    return int(found[0])


class Barrier:
    """An mbarrier: ``count`` arrivals complete a phase."""

    def __init__(self, count=WARP):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self, n=1):
        for _ in range(n):
            self.pending -= 1
            if self.pending == 0:
                self.phase += 1
                self.pending = self.count

    def passed(self, parity):
        """``mbarrier.try_wait.parity``: the phase of this parity is done."""
        return self.phase % 2 != parity


def pieces(nt, nc, C, T, lane):
    """``for_pieces``: this lane's (instruction, u, q, bytes)."""
    Q = C // 4
    if nc == C:
        rows = WARP // Q
        q = 4 * (lane % Q)
        return [(j, lane // Q + j * rows, q, 16)
                for j in range(-(-T // rows))
                if lane < rows * Q and lane // Q + j * rows < nt]
    quads = (nc + 3) // 4
    out = []
    for j, i in enumerate(range(lane, nt * quads, WARP)):
        u = i // quads
        q = 4 * (i - u * quads)
        out.append((j, u, q, 4 * min(4, nc - q)))
    return out


def elements(nt, nc, lane):
    """``for_elements``: this lane's (instruction, u, c, 4)."""
    return [(j, i // nc, i % nc, 4)
            for j, i in enumerate(range(lane, nt * nc, WARP))]


def warp_plan(per_lane):
    """The warp's instructions, each the (lane, u, col, n) of its copies."""
    plan = {}
    for lane, items in enumerate(per_lane):
        for j, u, col, nbytes in items:
            plan.setdefault(j, []).append((lane, u, col, nbytes // 4))
    return [plan[j] for j in sorted(plan)]


class Source:
    """A float32 (B, S, R) view: flat storage, offset and strides in
    elements (the last dim contiguous)."""

    def __init__(self, flat, off, bstride, sstride, shape):
        self.flat, self.off = flat, off
        self.bstride, self.sstride, self.shape = bstride, sstride, shape

    def aligned(self):
        return scan_ops.rglru_rows_aligned(4 * self.off, self.bstride,
                                           self.sstride)

    def torch(self):
        return torch.as_strided(torch.from_numpy(self.flat), self.shape,
                                (self.bstride, self.sstride, 1), self.off)


def emulate(a, b, h0, C, T, N, rng, skip_empty=False):
    """Run the kernel's schedule on Sources ``a`` and ``b`` and h0 (B, R).
    Returns (hs, hT, fills a slot), or None if the schedule hangs."""
    B, S, R = a.shape
    checks = not skip_empty
    vec_in = a.aligned() and b.aligned()
    vec_out = R % 4 == 0
    sub = min(32, T)
    hs = np.full((B, S, R), np.nan, np.float32)
    writes = np.zeros((B, S, R), np.int64)
    hT = np.full((B, R), np.nan, np.float32)
    pending = []                       # copies in flight, of every CTA
    actors = []
    fills = []

    def cta(bi, c0):
        nc = min(C, R - c0)
        ring = np.full((2, N, T, C), np.nan, np.float32)
        stamp = np.full((2, N, T, C), -1, np.int64)  # stage of each cell
        out = np.full((2, T, C), np.nan, np.float32)
        out_stamp = np.full((2, T, C), -1, np.int64)
        full = [Barrier() for _ in range(N)]
        empty = [Barrier() for _ in range(N)]
        out_full = [Barrier(), Barrier()]
        out_empty = [Barrier(), Barrier()]
        released = [-1] * N            # last stage released, a slot
        out_released = [-1, -1]
        outstanding = [set() for _ in range(WARP)]
        arrivals = []                  # (lane, last copy seq, barrier)
        seq = [0]
        n_fills = [0] * N
        fills.append(n_fills)

        def fire():
            for item in list(arrivals):
                lane, last, bar = item
                if not any(x <= last for x in outstanding[lane]):
                    arrivals.remove(item)
                    bar.arrive()

        def land(copy):
            k, slot, s, u, col, vals, lane, sq = copy
            if checks:   # refilled only after the previous stage's release
                assert s < N or released[slot] == s - N, (slot, s)
            ring[k, slot, u, col:col + len(vals)] = vals
            stamp[k, slot, u, col:col + len(vals)] = s
            outstanding[lane].discard(sq)
            fire()

        def producer():
            phase = slot = 0
            for s, t0 in enumerate(range(0, S, T)):
                nt = min(T, S - t0)
                if not skip_empty:
                    yield lambda e=empty[slot], p=phase ^ 1: e.passed(p)
                n_fills[slot] += 1
                for k, src in enumerate((a, b)):
                    per_lane = [pieces(nt, nc, C, T, lane) if vec_in else
                                elements(nt, nc, lane)
                                for lane in range(WARP)]
                    cover = np.zeros((nt, nc), np.int64)
                    for instr in warp_plan(per_lane):
                        for lane, u, col, n in instr:
                            n = min(n, nc - col)   # the partial piece
                            assert t0 + u < S and c0 + col + n <= R
                            base = (src.off + bi * src.bstride
                                    + (t0 + u) * src.sstride + c0 + col)
                            seq[0] += 1
                            outstanding[lane].add(seq[0])
                            cover[u, col:col + n] += 1
                            pending.append((land, (
                                k, slot, s, u, col,
                                src.flat[base:base + n].copy(), lane,
                                seq[0])))
                        yield None
                    assert (cover == 1).all()
                for lane in range(WARP):   # cp.async.mbarrier.arrive.noinc
                    arrivals.append((lane, seq[0], full[slot]))
                fire()
                yield None
                slot = (slot + 1) % N
                phase ^= slot == 0

        def consumer():
            h = h0[bi, c0:c0 + nc].astype(np.float32)
            phase = slot = 0
            for s, t0 in enumerate(range(0, S, T)):
                nt, o = min(T, S - t0), s & 1
                yield lambda f=full[slot], p=phase: f.passed(p)
                yield lambda e=out_empty[o], p=((s >> 1) & 1) ^ 1: \
                    e.passed(p)
                if checks:   # each output stage reused after its release
                    assert s < 2 or out_released[o] == s - 2
                for k in range(T // sub):
                    rows = slice(k * sub, (k + 1) * sub)
                    ra = ring[0, slot, rows, :nc].copy()
                    rb = ring[1, slot, rows, :nc].copy()
                    if checks:   # read only after the stage's own fill
                        live = max(0, min(sub, nt - k * sub))
                        assert (stamp[:, slot, k * sub:k * sub + live, :nc]
                                == s).all(), (slot, s)
                    if k == T // sub - 1:
                        released[slot] = s
                        empty[slot].arrive(WARP)
                    yield None
                    for u in range(sub):
                        t = k * sub + u
                        if t < nt:
                            h = np.multiply(ra[u], h, dtype=np.float32)
                            h = np.add(h, rb[u], dtype=np.float32)
                            out[o, t, :nc] = h
                            out_stamp[o, t, :nc] = s
                    yield None
                out_full[o].arrive(WARP)
                slot = (slot + 1) % N
                phase ^= slot == 0
            hT[bi, c0:c0 + nc] = h

        def storer():
            for s, t0 in enumerate(range(0, S, T)):
                nt, o = min(T, S - t0), s & 1
                yield lambda f=out_full[o], p=(s >> 1) & 1: f.passed(p)
                if checks:
                    assert (out_stamp[o, :nt, :nc] == s).all(), (o, s)
                per_lane = [pieces(nt, nc, C, T, lane) if vec_out else
                            elements(nt, nc, lane) for lane in range(WARP)]
                for instr in warp_plan(per_lane):
                    for _, u, col, n in instr:
                        hs[bi, t0 + u, c0 + col:c0 + col + n] = \
                            out[o, u, col:col + n]
                        writes[bi, t0 + u, c0 + col:c0 + col + n] += 1
                    yield None
                out_released[o] = s
                out_empty[o].arrive(WARP)

        return [producer(), consumer(), storer()]

    for bi in range(B):
        for c0 in range(0, R, C):
            actors += cta(bi, c0)
    waits = [None] * len(actors)
    weights = rng.uniform(0.2, 1.0, 2)   # memory vs the warps, this seed
    while actors or pending:
        ready = [i for i, w in enumerate(waits) if w is None or w()]
        if not ready and not pending:
            return None                  # hangs
        if pending and (not ready or rng.uniform() * weights.sum()
                        < weights[0]):
            fn, copy = pending.pop(int(rng.integers(len(pending))))
            fn(copy)
            continue
        i = ready[int(rng.integers(len(ready)))]
        try:
            waits[i] = next(actors[i])
        except StopIteration:
            del actors[i], waits[i]
    if checks:
        assert (writes == 1).all()
    return hs, hT, fills


def make_source(B, S, R, offset=0, pad=0):
    """A seeded (B, S, R) view ``offset`` elements into its storage, rows
    ``pad`` elements apart beyond R."""
    sstride = R + pad
    flat = np.zeros(offset + B * S * sstride, np.float32)
    return Source(flat, offset, S * sstride, sstride, (B, S, R))


def inputs(seed, B, S, R, offset=0, pad=0):
    rng = np.random.default_rng(seed)
    a = make_source(B, S, R, offset, pad)
    b = make_source(B, S, R, offset, pad)
    a.torch().copy_(torch.from_numpy(
        rng.uniform(0.2, 1.0, (B, S, R)).astype(np.float32)))
    b.torch().copy_(torch.from_numpy(
        rng.standard_normal((B, S, R)).astype(np.float32)))
    h0 = rng.standard_normal((B, R)).astype(np.float32)
    return a, b, h0


def _held(a, b, h0, got):
    hs, hT, _ = got
    ta, tb, th0 = a.torch(), b.torch(), torch.from_numpy(h0)
    for ws, wT in (rglru_scan_plain(ta, tb, th0),
                   rglru_reference(ta, tb, th0)):
        assert torch.equal(torch.from_numpy(hs), ws)
        assert torch.equal(torch.from_numpy(hT), wT)
    js, jT = jax_rglru(*(jnp.asarray(x) for x in (
        ta.contiguous().numpy(), tb.contiguous().numpy(), h0)))
    np.testing.assert_allclose(hs, np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(hT, np.asarray(jT), atol=1e-5)


# C channels a CTA, (T steps, N stages); S wraps the ring at least twice
# and ends on a partial stage; R ends on a partial channel tile
GRID = [(C, T, N) for C in (8, 16, 20) for T, N in ((8, 2), (32, 4),
                                                    (64, 6))]


@pytest.mark.parametrize("C,T,N", GRID)
def test_schedule_equals_plain_reference_and_jax(C, T, N):
    S = 2 * T * N + T // 2 + 3
    R = 2 * C + 4
    B = 2 if T < 64 else 1
    a, b, h0 = inputs(C * 100 + T, B, S, R)
    assert a.aligned()
    got = emulate(a, b, h0, C, T, N, np.random.default_rng([C, T, N]))
    assert got is not None
    assert min(min(f) for f in got[2]) >= 2     # every slot refilled
    _held(a, b, h0, got)


# at the built tile: (B, S, R, offset, pad) -- the ring wrapping, a last
# tile of 8 channels on 16-byte pieces; R not a multiple of 4 (4-byte
# copies and stores, a last tile of 18); rows one element into their
# storage (4-byte copies, 16-byte stores); S = 1; B x R below one CTA's
# channels (a partial tile of 12 on 16-byte pieces); rows padded to a
# stride of R + 3 (4-byte copies) with S not a multiple of T
LAYOUTS = [(1, 2 * T_BUILT * N_BUILT + 66, 40, 0, 0),
           (1, 100, 50, 0, 0), (2, 77, 64, 1, 0), (3, 1, 32, 0, 0),
           (1, 50, 12, 0, 0), (2, 130, 36, 0, 3)]


@pytest.mark.parametrize("B,S,R,offset,pad", LAYOUTS)
def test_built_tile_on_every_layout(B, S, R, offset, pad):
    a, b, h0 = inputs(B * 1000 + S + offset, B, S, R, offset, pad)
    assert a.aligned() == (offset % 4 == 0 and (R + pad) % 4 == 0)
    got = emulate(a, b, h0, C_BUILT, T_BUILT, N_BUILT,
                  np.random.default_rng([B, S, R]))
    assert got is not None
    _held(a, b, h0, got)


def test_several_schedules_of_one_input_agree():
    """Shuffled orders change nothing: hs is the plain version's on each."""
    a, b, h0 = inputs(7, 2, 40, 20)
    want = rglru_scan_plain(a.torch(), b.torch(), torch.from_numpy(h0))[0]
    for seed in range(6):
        hs, _, _ = emulate(a, b, h0, 8, 4, 2, np.random.default_rng(seed))
        assert torch.equal(torch.from_numpy(hs), want)


def test_skipping_the_empty_barrier_reads_a_refilled_stage():
    """Without the producer's wait on the empty barrier, it refills a
    stage the consumer has not read yet: some seed gives a wrong hs."""
    a, b, h0 = inputs(11, 1, 64, 16)
    want = rglru_scan_plain(a.torch(), b.torch(), torch.from_numpy(h0))[0]
    wrong = 0
    for seed in range(40):
        got = emulate(a, b, h0, 8, 4, 2, np.random.default_rng(seed),
                      skip_empty=True)
        if got is not None and not torch.equal(torch.from_numpy(got[0]),
                                               want):
            wrong += 1
    assert wrong > 0


def test_pieces_cover_each_tile_once():
    """``for_pieces`` and ``for_elements`` give every element of rows
    0 .. nt - 1 of an nc-channel tile to exactly one lane, for every C the
    ablation builds, full and partial tiles and stages."""
    for C in (8, 16, 20, 24, 32):
        for T in (8, 32, 64, 128):
            for nt in sorted({1, T // 2 + 1, T}):
                for nc in sorted({1, 3, 4, C - 1, C}):
                    for plan in (pieces, None):
                        cover = np.zeros((nt, nc), np.int64)
                        for lane in range(WARP):
                            items = (plan(nt, nc, C, T, lane) if plan
                                     else elements(nt, nc, lane))
                            for _, u, col, nbytes in items:
                                n = min(nbytes // 4, nc - col)
                                assert nbytes == 16 or n == nbytes // 4
                                cover[u, col:col + n] += 1
                        assert (cover == 1).all(), (C, T, nt, nc)


def test_mirror_matches_the_kernel_source():
    """ops.py's tile and alignment rule are the kernel's, and the kernel
    runs the routes this emulation models: three warps, two output stages,
    the rows of a and b by 16-byte copies when aligned."""
    assert _source_int("kChannels") == C_BUILT
    assert _source_int("kSteps") == T_BUILT
    assert _source_int("kStages") == N_BUILT
    assert _source_int("kAlignBytes") == scan_ops.RGLRU_ALIGN_BYTES
    assert _source_int("kThreads") == 3 * WARP
    assert _source_int("kOutStages") == 2
    text = " ".join((CSRC / "rglru_scan.cu").read_text().split())
    assert "kSub = kSteps < 32 ? kSteps : 32;" in text
    # rows_aligned: base on kAlignBytes, both strides whole kAlignBytes
    assert re.search(r"kAlignFloats = kAlignBytes / sizeof\(float\);"
                     r" return reinterpret_cast<uintptr_t>\(x\) % "
                     r"kAlignBytes == 0 && batch % kAlignFloats == 0 && "
                     r"seq % kAlignFloats == 0;", text)
    rule = scan_ops.rglru_rows_aligned
    assert rule(0, 4 * 2560, 2560) and rule(32, 8, 4)
    assert not rule(4, 4 * 2560, 2560)        # one element in
    assert not rule(0, 5 * 50, 50)            # R = 50: rows 200 bytes apart
    assert not rule(0, 4 * 64, 66)            # a padded seq stride


def test_ablation_variants_patch_the_kernel_source():
    """``tools/rglru_scan_ablation.py`` builds each variant by textual
    patches of the source (a setting, or the paths the kernel does not
    build, each patch applying exactly once), and leaves out those equal
    to the source or past a CTA's shared memory."""
    path = ROOT / "tools" / "rglru_scan_ablation.py"
    spec = importlib.util.spec_from_file_location("rglru_ablation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    variants = tool.sources(None)
    built = variants["as_built"]
    assert "cp.async.bulk." not in built       # no bulk-copy instruction
    assert tool.smem_bytes(built) == (16 * (N_BUILT + 2) + 4 * (
        2 * N_BUILT + 2) * T_BUILT * C_BUILT)
    assert set(tool.PATCHES) <= set(variants)
    for name, text in variants.items():
        if name == "as_built":
            continue
        assert text != built and tool.smem_bytes(text) <= tool.SMEM_LIMIT
        c, t, n = (tool._setting(text, p) for p in (
            tool.CHANNELS_SET, tool.STEPS_SET, tool.STAGES_SET))
        if name.startswith("C"):
            assert (c, t, n) == (int(name[1:]), T_BUILT, N_BUILT)
        elif name.startswith("T"):
            assert (c, f"T{t}N{n}") == (C_BUILT, name)
        else:
            assert (c, t, n) == (C_BUILT, T_BUILT, N_BUILT)
            assert text == tool.patched(built, tool.PATCHES[name])
    regs = variants["regs_store"]
    assert tool._setting(regs, tool.OUT_STAGES_SET) == 0
    assert "kThreads = 64;" in regs and "out[t * ostride + cl] = h;" in regs
    assert "cp.async.bulk.global.shared::cta" in variants["bulk_store"]
    assert "fence.proxy.async" in variants["bulk_store"]
    assert "complete_tx::bytes" in variants["bulk_load"]
    assert f"C{C_BUILT}" not in variants
    assert f"T{T_BUILT}N{N_BUILT}" not in variants
    with pytest.raises(RuntimeError):
        tool.patched(built, [("no such line", "")])
