"""The port's label-propagation kernel against the JAX reference.

On the CPU ``propagate`` runs its plain PyTorch version; it is held
element-wise (exact: labels are only compared and moved) against the
reference's XLA twin ``label_step_xla``, its Pallas kernel in interpret
mode (``label_step(..., n_shards=K, interpret=True)``), the numpy oracles
of ``kernels/label_prop/ref.py`` and the reference's ``connected_components``
/ ``merge_labels``, on the same seeded numpy graphs, at every iteration
of a fixpoint.  The kernel's fixpoint and merge bodies are emulated in
torch (``ConcurrentUnionFind``, ``emulate_fixpoint``, ``emulate_merge``):
their hooks interleaved in seeded random orders, with CAS failures and
retries, held to the same oracles.  The ``gpu`` test holds the CUDA kernel
against the plain version on the card and skips without one.
"""
import bisect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.label_prop import ops as jops
from repro.kernels.label_prop.ref import (components_reference,
                                          label_step_reference)
from repro_torch.kernels import label_prop
from repro_torch.kernels.label_prop import ref as tref
from repro_torch.kernels.label_prop.ops import (MAX_ITERS, SMALL_E,
                                                label_step_plain, pick_body,
                                                propagate, propagate_plain)

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
      / "csrc" / "label_prop.cu")

N = 48


def graph(seed, n=N):
    """Seeded edges: random pairs, (0,0) padding, self-loops, duplicates,
    a chain segment, and isolated vertices past n - 8."""
    rng = np.random.default_rng(seed)
    E = int(rng.integers(0, 3 * n // 2))
    eu = rng.integers(0, n - 8, E)
    ev = rng.integers(0, n - 8, E)
    eu[rng.random(E) < 0.15] = 0
    ev[eu == 0] = 0
    loop = rng.random(E) < 0.1
    ev[loop] = eu[loop]
    if E > 4:
        eu[-2:], ev[-2:] = eu[:2], ev[:2]                  # duplicates
    start = int(rng.integers(0, n // 2))
    chain = np.arange(start, start + 6)
    eu = np.concatenate([eu, chain[:-1]]).astype(np.int32)
    ev = np.concatenate([ev, chain[1:]]).astype(np.int32)
    return eu, ev


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


@pytest.mark.parametrize("seed", range(6))
def test_plain_step_equals_reference_steps_at_every_iteration(seed):
    eu, ev = graph(seed)
    l = np.arange(N, dtype=np.int32)
    for _ in range(4 * N):
        got = label_step_plain(_t(l), _t(eu), _t(ev)).numpy()
        xla = np.asarray(jops.label_step_xla(jnp.asarray(l), jnp.asarray(eu),
                                             jnp.asarray(ev)))
        np.testing.assert_array_equal(got, xla)
        np.testing.assert_array_equal(got, label_step_reference(l, eu, ev))
        np.testing.assert_array_equal(got, tref.label_step_reference(l, eu,
                                                                     ev))
        # the dispatching wrapper (max_iters = 1) on a CPU tensor
        np.testing.assert_array_equal(
            label_prop.label_step(_t(l), _t(eu), _t(ev)).numpy(), got)
        if np.array_equal(got, l):
            break
        l = got
    else:
        pytest.fail("no fixpoint")


@pytest.mark.parametrize("K", [1, 2, 4])
def test_plain_step_equals_pallas_kernel_in_interpret_mode(K):
    eu, ev = graph(10 + K)
    l = np.arange(N, dtype=np.int32)
    while True:
        got = label_step_plain(_t(l), _t(eu), _t(ev)).numpy()
        pallas = np.asarray(jops.label_step(
            jnp.asarray(l), jnp.asarray(eu), jnp.asarray(ev), n_shards=K,
            interpret=True))
        np.testing.assert_array_equal(got, pallas)
        if np.array_equal(got, l):
            break
        l = got


@pytest.mark.parametrize("seed", range(4))
def test_plain_fixpoint_equals_reference_connected_components(seed):
    eu, ev = graph(20 + seed)
    got = label_prop.connected_components(_t(eu), _t(ev), n=N).numpy()
    want = components_reference(N, zip(eu.tolist(), ev.tolist()))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tref.components_reference(
        N, zip(eu.tolist(), ev.tolist())))
    for use_pallas in (False, True):
        j = np.asarray(jops.connected_components(
            jnp.asarray(eu), jnp.asarray(ev), n=N, n_shards=2,
            use_pallas=use_pallas, interpret=True))
        np.testing.assert_array_equal(got, j)


@pytest.mark.parametrize("seed", range(4))
def test_plain_merge_labels_equals_reference(seed):
    eu, ev = graph(30 + seed)
    k = len(eu) // 2
    base = components_reference(N, zip(eu[:k].tolist(), ev[:k].tolist()))
    bu, bv = eu[k:k + 12], ev[k:k + 12]
    got = label_prop.merge_labels(_t(base), _t(bu), _t(bv), n=N).numpy()
    want = np.asarray(jops.merge_labels(jnp.asarray(base), jnp.asarray(bu),
                                        jnp.asarray(bv), n=N))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, components_reference(
        N, zip(eu[:k + 12].tolist(), ev[:k + 12].tolist())))
    # a no-op batch: (0,0) slots only, and no edge at all
    zeros = np.zeros(5, np.int32)
    for u, v in ((zeros, zeros), (zeros[:0], zeros[:0])):
        got = label_prop.merge_labels(_t(base), _t(u), _t(v), n=N).numpy()
        np.testing.assert_array_equal(got, base)
        if u.size:
            np.testing.assert_array_equal(got, np.asarray(jops.merge_labels(
                jnp.asarray(base), jnp.asarray(u), jnp.asarray(v), n=N)))


def test_propagate_options_match_their_definitions():
    """valid masks and live counts sanitize to (0,0); the gates decide;
    relabel is merge_labels; max_iters counts steps."""
    eu, ev = graph(40)
    E = len(eu)
    rng = np.random.default_rng(41)
    valid = rng.random(E) < 0.6
    junk_u, junk_v = eu.copy(), ev.copy()
    junk_u[~valid] = rng.integers(0, N, (~valid).sum())
    junk_v[~valid] = rng.integers(0, N, (~valid).sum())
    out = torch.empty(N, dtype=torch.int32)
    steps = propagate(_t(junk_u), _t(junk_v), out,
                      valid=torch.from_numpy(valid))
    want = components_reference(N, zip(eu[valid].tolist(),
                                       ev[valid].tolist()))
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(steps) >= 1
    # live prefix on a tensor count
    k = E // 3
    out = torch.empty(N, dtype=torch.int32)
    propagate(_t(eu), _t(ev), out, e_live=torch.tensor(k, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), components_reference(
        N, zip(eu[:k].tolist(), ev[:k].tolist())))
    # gates: nothing happens unless when and not unless
    base = torch.from_numpy(want.copy())
    for kw in (dict(when=torch.tensor(False)),
               dict(unless=torch.tensor(True))):
        o = base.clone()
        assert int(propagate(_t(eu), _t(ev), o, **kw)) == 0
        assert torch.equal(o, base)
    # relabel == merge_labels; an empty live set is the identity
    o = base.clone()
    propagate(_t(eu), _t(ev), o, relabel=True,
              unless=torch.tensor(False))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jops.merge_labels(
        jnp.asarray(want), jnp.asarray(eu), jnp.asarray(ev), n=N)))
    o = base.clone()
    assert int(propagate(_t(eu), _t(ev), o, relabel=True,
                         e_live=torch.tensor(0, dtype=torch.int32))) == 0
    assert torch.equal(o, base)
    # max_iters: two single steps == one two-step launch
    l1 = torch.empty(N, dtype=torch.int32)
    propagate(_t(eu), _t(ev), l1, max_iters=1)
    l2 = torch.empty(N, dtype=torch.int32)
    propagate(_t(eu), _t(ev), l2, init=l1, max_iters=1)
    both = torch.empty(N, dtype=torch.int32)
    assert int(propagate(_t(eu), _t(ev), both, max_iters=2)) == 2
    assert torch.equal(both, l2)


# ---------------------------------------------------------------------------
# The kernel's fixpoint and merge bodies, emulated (csrc/label_prop.cu)
# ---------------------------------------------------------------------------
FILTER_BITS = 14                      # label_prop.cu's kFilterBits


class ConcurrentUnionFind:
    """``find_root`` and ``link`` of ``label_prop.cu`` as generators over a
    shared ``parent`` tensor: every read or write of it is one step, and
    :func:`interleave` runs many threads at once in a seeded random order.
    A thread whose root another thread links between its read and its CAS
    sees the CAS fail and retries from the new roots (``cas_failures``)."""

    def __init__(self, n):
        self.parent = torch.arange(n, dtype=torch.int32)
        self.cas_failures = 0

    def find(self, x):
        P = self.parent
        p = int(P[x])
        yield
        while p != x:
            g = int(P[p])
            yield
            if g == p:
                return p
            assert g <= p <= x           # parent[x] <= x: no cycle
            P[x] = g                     # path halving
            yield
            x = g
            p = int(P[x])
            yield
        return x

    def link(self, u, v):
        ru = yield from self.find(u)
        rv = yield from self.find(v)
        while ru != rv:
            lo, hi = min(ru, rv), max(ru, rv)
            old = int(self.parent[hi])   # atomicCAS(&parent[hi], hi, lo)
            if old == hi:
                self.parent[hi] = lo
                return
            self.cas_failures += 1
            yield
            ru = yield from self.find(lo)
            rv = yield from self.find(old)


def interleave(threads, rng):
    """Run the generators to their ends, one step of a random one at a
    time."""
    live = list(threads)
    while live:
        i = int(rng.integers(len(live)))
        try:
            next(live[i])
        except StopIteration:
            live.pop(i)


def _gated(when, unless):
    return (when is not None and not bool(when)) or (
        unless is not None and bool(unless))


def _slots(eu, ev, valid, e_live):
    """The live slot count and each slot's endpoints, masked to (0, 0)."""
    E = eu.numel() if e_live is None else min(eu.numel(), max(int(e_live), 0))
    ends = [(int(eu[e]), int(ev[e])) if valid is None or bool(valid[e])
            else (0, 0) for e in range(E)]
    return E, ends


def emulate_fixpoint(eu, ev, out, rng, *, valid=None, e_live=None,
                     relabel=False, when=None, unless=None):
    """Body 2 in place on ``out``: identity parents, then every live slot
    one thread hooking its (mapped) endpoints, in a shuffled order and
    interleaved, then every vertex one thread flattening, interleaved.
    Returns (the kernel's return value, CAS failures)."""
    E, ends = _slots(eu, ev, valid, e_live)
    if _gated(when, unless) or (relabel and E == 0):
        return 0, 0
    n = out.numel()
    uf = ConcurrentUnionFind(n)
    hooks = []
    for e in rng.permutation(E):
        u, v = ends[e]
        if relabel:
            u, v = int(out[u]), int(out[v])
        if u != v:
            hooks.append(uf.link(u, v))
    interleave(hooks, rng)
    roots = [0] * n

    def flatten(x):
        roots[x] = yield from uf.find(int(out[x]) if relabel else x)

    interleave([flatten(x) for x in range(n)], rng)
    out.copy_(torch.tensor(roots, dtype=torch.int32))
    return 1, uf.cas_failures


def filter_hash(label):
    return ((label * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - FILTER_BITS)


def build_table(io, ends, rng):
    """``build_table`` of the merge body: the endpoint labels, each one's
    position among them (equal labels by slot order), the union-find over
    the positions (the slots' hooks and equal neighbours' hooks,
    interleaved), each position's new label and the filter of the labels
    that change."""
    lab = [int(io[x]) for uv in ends for x in uv]
    m = len(lab)
    pos = [sum(lab[j] < lab[i] or (lab[j] == lab[i] and j < i)
               for j in range(m)) for i in range(m)]
    sorted_ = [0] * m
    for i in range(m):
        sorted_[pos[i]] = lab[i]
    assert sorted_ == sorted(lab)
    uf = ConcurrentUnionFind(m)
    hooks = [uf.link(pos[2 * e], pos[2 * e + 1]) for e in range(len(ends))]
    hooks += [uf.link(i - 1, i) for i in range(1, m)
              if sorted_[i] == sorted_[i - 1]]
    interleave(hooks, rng)
    root, filt = [], set()
    for i in range(m):
        r = i
        while int(uf.parent[r]) != r:
            r = int(uf.parent[r])
        root.append(sorted_[r])
        if root[i] != sorted_[i]:
            filt.add(filter_hash(sorted_[i]))
    return sorted_, root, filt


def new_label(table, x):
    sorted_, root, filt = table
    if filter_hash(x) not in filt:
        return x
    i = bisect.bisect_left(sorted_, x)
    return root[i] if i < len(sorted_) and sorted_[i] == x else x


def emulate_merge(eu, ev, out, rng, *, valid=None, e_live=None, when=None,
                  unless=None, blocks=3, staged=True):
    """Body 3 in place on ``out``, its labels cut into ``blocks`` stripes.
    ``staged``: every block builds its table before any block writes (the
    kernel's grid barrier; the tables must agree); else block b reads its
    endpoint labels after blocks < b rewrote their stripes — the race the
    barrier prevents.  Returns the kernel's return value."""
    assert eu.numel() <= SMALL_E
    E, ends = _slots(eu, ev, valid, e_live)
    if _gated(when, unless) or E == 0:
        return 0
    stripes = np.array_split(np.arange(out.numel()), blocks)
    if staged:
        tables = [build_table(out, ends, rng) for _ in stripes]
        assert all(t[:2] == tables[0][:2] for t in tables)
    for b, stripe in enumerate(stripes):
        t = tables[b] if staged else build_table(out, ends, rng)
        for x in stripe:
            out[x] = new_label(t, int(out[x]))
    return 1


def emulated(eu, ev, out, rng, **kw):
    """What ``propagate`` runs on the card for a fixpoint-form call, by
    :func:`pick_body`: the merge body or the fixpoint body."""
    if pick_body(eu.numel(), relabel=kw.get("relabel", False)) == "merge":
        kw.pop("relabel")
        return emulate_merge(eu, ev, out, rng, **kw), 0
    return emulate_fixpoint(eu, ev, out, rng, **kw)


def _junk(eu, ev, valid, rng, n=N):
    """Random vertex ids in the masked slots (``valid`` must hide them)."""
    ju, jv = eu.copy(), ev.copy()
    ju[~valid] = rng.integers(0, n, (~valid).sum())
    jv[~valid] = rng.integers(0, n, (~valid).sum())
    return ju, jv


def fixpoint_cases(seed, n=N):
    """``(name, eu, ev, kw, edges)``: the graph ``edges`` means (what the
    masks leave) beside what a call gets."""
    rng = np.random.default_rng([seed, 70])
    eu, ev = graph(seed, n)
    E = len(eu)
    cases = [("random", eu, ev, {}, (eu, ev))]
    order = rng.permutation(n - 1).astype(np.int32)
    cases.append(("chain", order, order + 1, {}, (order, order + 1)))
    perm = rng.permutation(n).astype(np.int32)
    par = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    keep = rng.random(n - 1) < 0.85
    fu, fv = perm[1:][keep], perm[par][keep]
    cases.append(("forest", fu, fv, {}, (fu, fv)))
    valid = rng.random(E) < 0.6
    ju, jv = _junk(eu, ev, valid, rng, n)
    cases.append(("invalid", ju, jv, dict(valid=torch.from_numpy(valid)),
                  (eu[valid], ev[valid])))
    k = E // 3
    cases.append(("e_live", eu, ev,
                  dict(e_live=torch.tensor(k, dtype=torch.int32)),
                  (eu[:k], ev[:k])))
    cases.append(("when", eu, ev, dict(when=torch.tensor(True)), (eu, ev)))
    cases.append(("empty", eu[:0], ev[:0], {}, (eu[:0], ev[:0])))
    return cases


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", ["random", "chain", "forest", "invalid",
                                  "e_live", "when", "empty"])
def test_fixpoint_body_emulation_equals_plain_and_reference(seed, case):
    """Body 2 over 3 shuffled, interleaved hook orders == the plain
    fixpoint == the JAX ``connected_components`` == the union-find oracle,
    with the new return value (1) on both."""
    name, eu, ev, kw, (gu, gv) = next(
        c for c in fixpoint_cases(60 + seed) if c[0] == case)
    want = torch.empty(N, dtype=torch.int32)
    assert int(propagate_plain(_t(eu), _t(ev), want, **kw)) == 1
    np.testing.assert_array_equal(want.numpy(), components_reference(
        N, zip(gu.tolist(), gv.tolist())))
    if len(gu):
        j = np.asarray(jops.connected_components(
            jnp.asarray(gu), jnp.asarray(gv), n=N))
        np.testing.assert_array_equal(want.numpy(), j)
    for order in range(3):
        rng = np.random.default_rng([seed, order, 71])
        got = torch.empty(N, dtype=torch.int32)
        ret, _ = emulate_fixpoint(_t(eu), _t(ev), got, rng, **kw)
        assert ret == 1
        assert torch.equal(got, want), (name, order)


def test_fixpoint_body_emulation_retries_failed_cas():
    """A chain of 300 vertices in shuffled edge order (deep trees before
    halving shortens them) and dense random graphs of 100 vertices, where
    several hooks race to hang one root: CASes fail and retry, and the
    labels are still the component min."""
    failures = 0
    for seed in range(3):
        rng = np.random.default_rng([seed, 72])
        order = rng.permutation(299).astype(np.int32)
        got = torch.empty(300, dtype=torch.int32)
        assert emulate_fixpoint(_t(order), _t(order + 1), got, rng)[0] == 1
        assert torch.equal(got, torch.zeros(300, dtype=torch.int32))
        eu = rng.integers(0, 100, 150).astype(np.int32)
        ev = rng.integers(0, 100, 150).astype(np.int32)
        got = torch.empty(100, dtype=torch.int32)
        ret, f = emulate_fixpoint(_t(eu), _t(ev), got, rng)
        assert ret == 1
        np.testing.assert_array_equal(got.numpy(), components_reference(
            100, zip(eu.tolist(), ev.tolist())))
        failures += f
    assert failures > 0


def test_fixpoint_body_emulation_of_the_gates():
    eu, ev = graph(73)
    base = torch.from_numpy(components_reference(
        N, zip(eu[:5].tolist(), ev[:5].tolist())))
    for kw in (dict(when=torch.tensor(False)), dict(unless=torch.tensor(True)),
               dict(relabel=True, e_live=torch.tensor(0, dtype=torch.int32))):
        want, got = base.clone(), base.clone()
        assert int(propagate_plain(_t(eu), _t(ev), want, **kw)) == 0
        assert emulate_fixpoint(_t(eu), _t(ev), got,
                                np.random.default_rng(0), **kw) == (0, 0)
        assert torch.equal(got, base) and torch.equal(want, base)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("slots", [16, 2 * 16 + 1, SMALL_E, SMALL_E + 1])
def test_relabel_bodies_emulated_on_both_sides_of_small_e(seed, slots):
    """The relabel form by the body ``propagate`` picks — the merge at ≤
    SMALL_E slots, the fixpoint past it — on every slot live, a live prefix
    (``e_live``, junk past it) and a valid mask: == the plain merge == the
    JAX ``merge_labels`` == the oracle of all the edges, 3 orders each."""
    assert pick_body(slots, relabel=True) == (
        "merge" if slots <= SMALL_E else "fixpoint")
    rng = np.random.default_rng([seed, 75])
    eu, ev = graph(80 + seed)
    k = len(eu) // 2
    base = components_reference(N, zip(eu[:k].tolist(), ev[:k].tolist()))
    pu = rng.integers(0, N, slots).astype(np.int32)
    pv = rng.integers(0, N, slots).astype(np.int32)
    loop = rng.random(slots) < 0.1
    pv[loop] = pu[loop]                                   # self-loops
    pu[-2:], pv[-2:] = pu[:2], pv[:2]                     # duplicates
    live = int(rng.integers(1, slots + 1))
    valid = rng.random(slots) < 0.7
    for kw, (gu, gv) in (
            ({}, (pu, pv)),
            (dict(e_live=torch.tensor(live, dtype=torch.int32),
                  unless=torch.tensor(False)), (pu[:live], pv[:live])),
            (dict(valid=torch.from_numpy(valid)), (pu[valid], pv[valid]))):
        want = torch.from_numpy(base.copy())
        assert int(propagate_plain(_t(pu), _t(pv), want, relabel=True,
                                   **kw)) == 1
        j = np.asarray(jops.merge_labels(
            jnp.asarray(base), jnp.asarray(gu), jnp.asarray(gv), n=N)) \
            if len(gu) else base
        np.testing.assert_array_equal(want.numpy(), j)
        np.testing.assert_array_equal(want.numpy(), components_reference(
            N, zip(list(eu[:k]) + list(gu), list(ev[:k]) + list(gv))))
        for order in range(3):
            got = torch.from_numpy(base.copy())
            ret, _ = emulated(_t(pu), _t(pv), got,
                              np.random.default_rng([seed, order, 76]),
                              relabel=True, **kw)
            assert ret == 1 and torch.equal(got, want), (kw.keys(), order)


def test_merge_without_staging_reads_rewritten_labels():
    """io is the merge's input and its output: a block that reads its
    endpoint labels after another block rewrote its stripe gets a wrong
    answer — vertex 6 (label 2) keeps 2 when edge (0, 2) relabels 2 to 0.
    With the barrier's staging every block reads first, and it is right."""
    io = torch.tensor([0, 1, 2, 3, 4, 5, 2, 7], dtype=torch.int32)
    eu, ev = _t([0]), _t([2])
    want = io.clone()
    propagate_plain(eu, ev, want, relabel=True)
    assert want.tolist() == [0, 1, 0, 3, 4, 5, 0, 7]
    rng = np.random.default_rng(77)
    staged, racy = io.clone(), io.clone()
    assert emulate_merge(eu, ev, staged, rng, blocks=2) == 1
    assert torch.equal(staged, want)
    emulate_merge(eu, ev, racy, rng, blocks=2, staged=False)
    assert racy.tolist() == [0, 1, 0, 3, 4, 5, 2, 7]
    # and on random merges: staged always right, unstaged wrong on some
    wrong = 0
    for seed in range(12):
        eu, ev = graph(90 + seed)
        k = len(eu) // 2
        base = torch.from_numpy(components_reference(
            N, zip(eu[:k].tolist(), ev[:k].tolist())))
        bu, bv = _t(eu[k:k + 20]), _t(ev[k:k + 20])
        want = base.clone()
        propagate_plain(bu, bv, want, relabel=True)
        staged, racy = base.clone(), base.clone()
        emulate_merge(bu, bv, staged, rng, blocks=4)
        assert torch.equal(staged, want)
        emulate_merge(bu, bv, racy, rng, blocks=4, staged=False)
        wrong += not torch.equal(racy, want)
    assert wrong > 0


def test_pick_body_by_form_and_slot_count():
    """No flag: the form of the call and the host-known slot count pick
    the body.  SMALL_E takes the graph's pending slots (2 c_max + 1) and
    the union-find's c_max unions, and is the .cu's kSmallE; the filter
    width is the .cu's too."""
    ident = torch.arange(N, dtype=torch.int32)
    assert pick_body(10 ** 6) == "fixpoint"
    assert pick_body(0) == "fixpoint"
    assert pick_body(SMALL_E + 1, relabel=True) == "fixpoint"
    for E in (0, 16, 2 * 16 + 1, SMALL_E):
        assert pick_body(E, relabel=True) == "merge"
    assert pick_body(5, init=ident) == "step"
    assert pick_body(5, max_iters=1) == "step"
    assert pick_body(5, relabel=True, max_iters=2) == "step"
    assert pick_body(5, max_iters=MAX_ITERS - 1) == "step"
    text = CU.read_text()
    assert int(re.search(r"kSmallE = (\d+);", text).group(1)) == SMALL_E
    assert int(re.search(r"kFilterBits = (\d+);", text).group(1)) \
        == FILTER_BITS
    assert SMALL_E >= 2 * 16 + 1


def test_return_contract():
    """The step form returns its steps; the fixpoint forms 1 when they ran,
    0 when gated off or when the relabel form has no live slot."""
    eu, ev = graph(78)
    l, steps = torch.arange(N, dtype=torch.int32), 0
    while True:
        l2 = label_step_plain(l, _t(eu), _t(ev))
        steps += 1
        if torch.equal(l2, l):
            break
        l = l2
    assert steps > 2
    out = torch.empty(N, dtype=torch.int32)
    ident = torch.arange(N, dtype=torch.int32)
    assert int(propagate(_t(eu), _t(ev), out)) == 1
    assert int(propagate(_t(eu), _t(ev), out.clone(), init=ident)) == steps
    assert int(propagate(_t(eu), _t(ev), out.clone(), max_iters=2)) == 2
    assert int(propagate(_t(eu), _t(ev), out.clone(), max_iters=0)) == 0
    assert int(propagate(_t(eu[:0]), _t(ev[:0]), out.clone())) == 1
    for kw in (dict(when=torch.tensor(False)), dict(unless=torch.tensor(True))):
        assert int(propagate(_t(eu), _t(ev), out.clone(), **kw)) == 0
        assert int(propagate(_t(eu), _t(ev), out.clone(), init=ident,
                             **kw)) == 0
    for E in (3, SMALL_E + 1):
        u, v = _t(np.resize(eu, E)), _t(np.resize(ev, E))
        assert int(propagate(u, v, out.clone(), relabel=True)) == 1
        assert int(propagate(u, v, out.clone(), relabel=True,
                             e_live=torch.tensor(0, dtype=torch.int32))) == 0
        assert int(propagate(u, v, out.clone(), relabel=True,
                             max_iters=1)) == 1
    assert int(propagate(_t(eu[:0]), _t(ev[:0]), out.clone(),
                         relabel=True)) == 0


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_cuda_kernel_equals_plain_version(cuda, seed):
    eu, ev = graph(50 + seed, n=4096)
    eu_t, ev_t = _t(eu).to(cuda), _t(ev).to(cuda)
    l = torch.arange(4096, dtype=torch.int32, device=cuda)
    while True:
        got, want = torch.empty_like(l), torch.empty_like(l)
        propagate(eu_t, ev_t, got, init=l, max_iters=1)
        propagate_plain(eu_t, ev_t, want, init=l, max_iters=1)
        assert torch.equal(got, want)
        if torch.equal(got, l):
            break
        l = got
    # the fixpoint body: 3 shuffled edge orders, each twice
    rng = np.random.default_rng([seed, 79])
    for _ in range(3):
        p = torch.from_numpy(rng.permutation(len(eu))).to(cuda)
        for _ in range(2):
            full = torch.empty_like(l)
            assert int(propagate(eu_t[p], ev_t[p], full)) == 1
            assert torch.equal(full, l)
    merged = full.clone()
    propagate(eu_t[:7], ev_t[:7], merged, relabel=True)
    assert torch.equal(merged, full)
    # the relabel form on both sides of SMALL_E (16: the union-find's
    # unions, 33: the graph's pending slots) on a labelling of half the
    # edges, all slots live and a live prefix, each 3 times
    half = torch.empty_like(l)
    propagate_plain(eu_t[: len(eu) // 2], ev_t[: len(eu) // 2], half)
    no = torch.zeros((), dtype=torch.bool, device=cuda)
    for slots in (16, 2 * 16 + 1, SMALL_E, SMALL_E + 1):
        u = torch.from_numpy(rng.integers(0, 4096, slots).astype(np.int32))
        v = torch.from_numpy(rng.integers(0, 4096, slots).astype(np.int32))
        u, v = u.to(cuda), v.to(cuda)
        live = torch.tensor(slots // 2, dtype=torch.int32, device=cuda)
        for kw in ({}, dict(e_live=live, unless=no)):
            want = half.clone()
            assert int(propagate_plain(u, v, want, relabel=True, **kw)) == 1
            for _ in range(3):
                got = half.clone()
                ret = propagate(u, v, got, relabel=True, **kw)
                assert int(ret) == 1 and torch.equal(got, want)


def test_merge_ablation_patches_apply_to_the_kernel_source():
    """``tools/label_prop_merge_ablation.py`` times the merge body without
    its preload and its filter by patching copies of the .cu: each patch
    must still match the source exactly once, and each variant must
    differ from the source."""
    import importlib.util

    path = CU.parents[4] / "tools" / "label_prop_merge_ablation.py"
    spec = importlib.util.spec_from_file_location("ablation", path)
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    text = CU.read_text()
    for name, patches in ablation.VARIANTS.items():
        out = ablation.patched(text, patches)
        assert (out == text) == (not patches), name
