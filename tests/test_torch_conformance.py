"""The conformance kit (DESIGN.md §16) on the port, and its battery.

The reference's kit (``tests/conformance.py``) drives a structure from
nothing but its registered ``StructureSpec`` — factory, host oracle, op
generators — and imports JAX, so it cannot run on the port.  This file
holds its port: every stage, written against ``repro_torch``'s registry
and tensors, parametrised over the port's five registered structures
(``pq``, ``graph``, ``unionfind``, ``map``, ``sketch``) on the CPU:

* :func:`check_differential` — seeded differential fuzz vs the oracle
  (update batches wider than ``c_max``, read batches, empty batches,
  periodic ``dump_compare``), plain and with ``donate=False``;
* :func:`check_one_sync` — counts ``spec.module``'s ``_host_fetch``:
  async dispatch makes no fetch, a read batch exactly one, and update
  handles resolve through it (the PQ: one fetch a consumed handle);
* :func:`check_donation` — the port's form of donation: ``donate=True``
  writes the pass into the storage the old state held (a content
  snapshot of it taken before the pass differs after), ``donate=False``
  leaves the old tensors bit for bit and moves the state to new storage;
* :func:`check_atomic_refusal` — ``spec.refusal_batch`` raises and leaves
  every tensor field of the state and the occupancy mirror bit-identical;
* :func:`check_rounds_equiv` — one oversized batch equals the same ops in
  ≤ ``c_max`` batches;
* :func:`check_megapass_vs_sequential` — R mixed rounds through ONE
  ``mixed_rounds`` equal the alternating dispatches and the oracle; a
  fused structure's registry flag, class flag and dispatch agree, its
  dispatch makes no fetch, one fetch resolves every handle, and it
  consumes the old state's storage (writes into it, or lets it go);
* :func:`check_fault_exactly_once` — injected dispatch failures lose and
  duplicate no op;
* :func:`make_structure_machine` — a hypothesis state machine over the
  same generators and oracle;
* :func:`check_placement_parity` — on every structure advertising
  ``supports_placement``: a one-rank ``MeshPlacement`` twin and the
  stacked twin take the same seeded traffic, answers and every (gathered)
  state leaf bit-equal, refusals atomic on both, the megapass and
  fault-injected restores included; the class flag and the registry's
  marker agree on every structure.

The broken toys of the reference's ``tests/test_conformance.py`` follow,
against the port's structures: each defect is caught by its stage.
"""
from __future__ import annotations

import contextlib
import importlib
import weakref
from typing import Any, Callable, List, Optional

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, settings
from hypothesis import strategies as st
from hypothesis.stateful import RuleBasedStateMachine, rule

from repro_torch.core import substrate
from repro_torch.core.faults import FaultPlan
from repro_torch.core.substrate import StructureSpec

substrate.load_builtins()
SPECS = sorted(substrate.names())


def make_cpu(spec: StructureSpec, **kw):
    """The spec's factory on the CPU (the port's entry points default to
    the card)."""
    return spec.make(device="cpu", **kw)


def leaves(state) -> List[torch.Tensor]:
    """Every tensor field of a state NamedTuple, nested tuples included."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (tuple, list)):
        return [t for x in state for t in leaves(x)]
    return []


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                    b.view(torch.int32) if b.dtype == torch.float32 else b))


# ---------------------------------------------------------------------------
# Shared drive loop
# ---------------------------------------------------------------------------
def _oracle_update(oracle, methods, inputs) -> List[Any]:
    """Oracles with a native ``update_batch`` own their in-batch rule
    (the union-find's pre-batch snapshot); per-op ``apply`` otherwise."""
    if hasattr(oracle, "update_batch"):
        return oracle.update_batch(list(methods), list(inputs))
    return [oracle.apply(m, i) for m, i in zip(methods, inputs)]


def run_differential(ds, oracle, spec: StructureSpec, rng, iters: int, *,
                     update_frac: float = 0.6, max_batch: int = 13,
                     dump_every: int = 7, ctx: Any = None) -> None:
    """Drive ``ds`` and ``oracle`` with the spec's own op generators and
    assert result- and state-equivalence throughout."""
    if ctx is None:
        ctx = spec.new_ctx()
    for it in range(iters):
        k = int(rng.integers(0, max_batch))   # 0: the empty-batch edge
        if rng.random() < update_frac:
            m, i = spec.gen_update(rng, k, ctx)
            got = _oracle_update(ds, m, i)
            want = _oracle_update(oracle, m, i)
        else:
            m, i = spec.gen_read(rng, k, ctx)
            got = ds.read_batch(list(m), list(i))
            want = [oracle.apply(mm, ii) for mm, ii in zip(m, i)]
        assert len(got) == len(want) == len(m)
        for mm, g, w in zip(m, got, want):
            assert spec.result_ok(mm, g, w), (spec.name, it, mm, g, w)
        if spec.dump_compare is not None and it % dump_every == 0:
            spec.dump_compare(ds, oracle)
    if spec.dump_compare is not None:
        spec.dump_compare(ds, oracle)


def check_differential(spec: StructureSpec, *, seed: int = 0,
                       iters: int = 40,
                       make: Optional[Callable[[], Any]] = None,
                       make_oracle: Optional[Callable] = None,
                       **drive_kw) -> None:
    rng = np.random.default_rng(seed)
    ds = (make or (lambda: make_cpu(spec)))()
    oracle = (make_oracle or spec.make_host)(ds)
    run_differential(ds, oracle, spec, rng, iters, **drive_kw)


# ---------------------------------------------------------------------------
# One-sync counting (the async one-fetch contract)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def count_fetches(spec: StructureSpec):
    """Count calls through ``spec.module``'s late-bound ``_host_fetch``
    hook — every blocking device→host transfer the structure makes."""
    mod = importlib.import_module(spec.module)
    orig = mod._host_fetch
    counter = {"n": 0}

    def counting(tree):
        counter["n"] += 1
        return orig(tree)

    mod._host_fetch = counting
    try:
        yield counter
    finally:
        mod._host_fetch = orig


def check_one_sync(spec: StructureSpec, *, seed: int = 123,
                   make: Optional[Callable[[], Any]] = None) -> None:
    """Async dispatch is sync-free; reads cost exactly ONE fetch."""
    ds = (make or (lambda: make_cpu(spec)))()
    rng = np.random.default_rng(seed)
    ctx = spec.new_ctx()
    m, i = spec.gen_update(rng, 6, ctx)
    ds.update_batch(list(m), list(i))
    mr, ir = spec.gen_read(rng, 4, ctx)
    ds.read_batch(list(mr), list(ir))
    with count_fetches(spec) as c:
        m1, i1 = spec.gen_update(rng, 5, ctx)
        h1 = ds.update_batch_async(list(m1), list(i1))
        m2, i2 = spec.gen_update(rng, 5, ctx)
        h2 = ds.update_batch_async(list(m2), list(i2))
        assert c["n"] == 0, \
            f"{spec.name}: async dispatch must not synchronize"
        if spec.reads_resolve_updates:
            mr, ir = spec.gen_read(rng, 4, ctx)
            ds.read_batch(list(mr), list(ir))
            assert c["n"] == 1, \
                f"{spec.name}: a read batch must cost exactly ONE fetch"
            h1.result()
            h2.result()
            assert c["n"] == 1, (f"{spec.name}: update handles must "
                                 "resolve through the read's fetch")
        else:
            # the PQ contract: one fetch per CONSUMED apply
            h1.result()
            assert c["n"] == 1, \
                f"{spec.name}: consuming a handle costs one fetch"
            h1.result()
            assert c["n"] == 1, \
                f"{spec.name}: re-consuming a handle must not refetch"
            h2.result()
            assert c["n"] <= 2
            n0 = c["n"]
            mr, ir = spec.gen_read(rng, 4, ctx)
            ds.read_batch(list(mr), list(ir))
            assert c["n"] == n0 + 1, \
                f"{spec.name}: a read batch must cost exactly ONE fetch"


# ---------------------------------------------------------------------------
# Donation (DESIGN.md §10): the pass writes the old storage, or moves
# ---------------------------------------------------------------------------
def _passes_observed(ds, spec, rng, ctx, batches: int = 8):
    """Apply ``batches`` update batches; for each one that changed the
    state, ``(written, moved)``: whether the pass wrote into the storage
    the old state held (its pre-pass content snapshot differs from what
    that storage holds now), and whether every field moved to new
    storage."""
    seen = []
    for _ in range(batches):
        old = leaves(ds.state)
        snap = [t.clone() for t in old]
        m, i = spec.gen_update(rng, 6, ctx)
        ds.update_batch(list(m), list(i))
        new = leaves(ds.state)
        if any(not _same_bits(s, n) for s, n in zip(snap, new)):
            seen.append((
                any(not _same_bits(s, o) for s, o in zip(snap, old)),
                all(o.data_ptr() != n.data_ptr() for o, n in zip(old, new))))
    return seen


def check_donation(spec: StructureSpec, *, seed: int = 7) -> None:
    """donate=True writes its passes into the old state's storage (the
    map and the sketch rewrite values in their old rows before the merge
    writes a fresh block, so a batch that revisits a key shows it); the
    ablation twin keeps the old tensors bit for bit and moves the state
    to new storage every pass."""
    for donate in (True, False):
        ds = make_cpu(spec, donate=donate)
        seen = _passes_observed(ds, spec, np.random.default_rng(seed),
                                spec.new_ctx())
        assert seen, f"{spec.name}: no update batch dispatched in 8 tries"
        if donate:
            assert any(w for w, _ in seen), \
                (f"{spec.name}: donate=True must write its passes into "
                 "the old state's storage")
        else:
            assert all(not w and m for w, m in seen), \
                (f"{spec.name}: donate=False must preserve the old "
                 "buffers and move the state to new storage")


# ---------------------------------------------------------------------------
# Atomic refusal (the sync-free guard contract)
# ---------------------------------------------------------------------------
def _fingerprint(ds) -> List[np.ndarray]:
    """Bit-exact host image of every tensor field of the state + the
    occupancy mirror."""
    out = [t.detach().cpu().numpy().copy() for t in leaves(ds.state)]
    for key in sorted(ds.occupancy_mirror()):
        out.append(np.array(ds.occupancy_mirror()[key], copy=True))
    return out


def check_atomic_refusal(spec: StructureSpec, *, seed: int = 11,
                         make: Optional[Callable[[], Any]] = None) -> None:
    """``spec.refusal_batch`` raises; state + mirror stay bit-identical;
    the structure still answers the oracle exactly afterwards."""
    assert spec.refusal_batch is not None, \
        f"{spec.name}: spec ships no refusal probe"
    rng = np.random.default_rng(seed)
    ds = (make or (lambda: make_cpu(spec)))()
    oracle = spec.make_host(ds)
    ctx = spec.new_ctx()
    m, i = spec.gen_update(rng, 6, ctx)
    ds.update_batch(list(m), list(i))
    _oracle_update(oracle, m, i)
    mr, ir = spec.gen_read(rng, 3, ctx)
    ds.read_batch(list(mr), list(ir))
    before = _fingerprint(ds)
    bm, bi = spec.refusal_batch(ds)
    raised = False
    try:
        ds.update_batch(list(bm), list(bi))
    except ValueError:
        raised = True
    assert raised, \
        f"{spec.name}: the refusal probe was accepted instead of refused"
    after = _fingerprint(ds)
    assert len(before) == len(after)
    for b, a in zip(before, after):
        np.testing.assert_array_equal(
            b.view(np.int32) if b.dtype == np.float32 else b,
            a.view(np.int32) if a.dtype == np.float32 else a,
            err_msg=f"{spec.name}: refusal was not atomic")
    run_differential(ds, oracle, spec, rng, 8)


# ---------------------------------------------------------------------------
# Rounds lowering ≡ sequence of single passes
# ---------------------------------------------------------------------------
def check_rounds_equiv(spec: StructureSpec, *, seed: int = 29,
                       n_ops: int = 27) -> None:
    """One oversized batch vs the same ops chunked into ≤ c_max single
    passes: both match the oracle op for op (each against its own batch
    boundaries) and land in the same state."""
    rng = np.random.default_rng(seed)
    ds_a, ds_b = make_cpu(spec), make_cpu(spec)
    oracle_a, oracle_b = spec.make_host(ds_a), spec.make_host(ds_b)
    ctx = spec.new_ctx()
    m, i = spec.gen_update(rng, n_ops, ctx)
    c_max = getattr(ds_a, "c_max", 8)
    assert n_ops > 2 * c_max, "probe must force the multi-round path"
    got_a = ds_a.update_batch(list(m), list(i))
    want_a = _oracle_update(oracle_a, m, i)
    for mm, g, w in zip(m, got_a, want_a):
        assert spec.result_ok(mm, g, w), (spec.name, "rounds", mm, g, w)
    for lo in range(0, n_ops, c_max):
        chunk_m, chunk_i = m[lo:lo + c_max], i[lo:lo + c_max]
        got_b = ds_b.update_batch(list(chunk_m), list(chunk_i))
        want_b = _oracle_update(oracle_b, chunk_m, chunk_i)
        for mm, g, w in zip(chunk_m, got_b, want_b):
            assert spec.result_ok(mm, g, w), (spec.name, "chunk", mm, g, w)
    assert spec.dump_compare is not None, f"{spec.name}: no dump_compare"
    spec.dump_compare(ds_a, oracle_a)
    spec.dump_compare(ds_b, oracle_b)


# ---------------------------------------------------------------------------
# Megapass ≡ sequential alternation (DESIGN.md §17)
# ---------------------------------------------------------------------------
def check_megapass_vs_sequential(spec: StructureSpec, *, seed: int = 37,
                                 n_rounds: int = 5,
                                 make: Optional[Callable[[], Any]] = None
                                 ) -> None:
    """R mixed update/read rounds through ONE ``mixed_rounds`` call equal
    the same rounds as separate alternating dispatches, and both the host
    oracle.  Fused structures also honor the dispatch contract: zero
    fetches at dispatch, ONE shared fetch for every handle, and the old
    state's storage consumed."""
    rng = np.random.default_rng(seed)
    mk = make or (lambda: make_cpu(spec))
    ds_m, ds_s = mk(), mk()
    declared = bool(getattr(type(ds_m), "supports_megapass", False))
    assert spec.megapass == declared, \
        (f"{spec.name}: registry megapass={spec.megapass} but the class "
         f"declares supports_megapass={declared}")
    base = substrate.BatchedStructure.mixed_rounds
    if not declared:
        assert type(ds_m).mixed_rounds is base, \
            (f"{spec.name}: declares supports_megapass=False yet "
             "overrides mixed_rounds — flag contradicts behavior")
    else:
        assert type(ds_m).mixed_rounds is not base, \
            (f"{spec.name}: declares supports_megapass=True but rides "
             "the base per-round fallback — flag contradicts behavior")
    oracle = spec.make_host(ds_s)
    ctx = spec.new_ctx()
    gen_read = spec.extras.get("megapass_read", spec.gen_read)
    c_max = int(getattr(ds_m, "c_max", 8))
    rounds = []
    for r in range(n_rounds):
        k = int(rng.integers(1, 2 * c_max + 2))   # force multi-row rounds
        if r % 2 == 0:
            m, i = spec.gen_update(rng, k, ctx)
            rounds.append(("update", list(m), list(i)))
        else:
            m, i = gen_read(rng, k, ctx)
            rounds.append(("read", list(m), list(i)))
    rounds.append(("update", [], []))             # empty-round edges
    rounds.append(("read", [], []))

    if spec.megapass:
        snap = [t.clone() for t in leaves(ds_m.state)]
        refs = [weakref.ref(t) for t in leaves(ds_m.state)]
        with count_fetches(spec) as c:
            hs_m = ds_m.mixed_rounds(rounds)
            assert c["n"] == 0, \
                f"{spec.name}: megapass dispatch must be sync-free"
            got = [h.result() for h in hs_m]
            assert c["n"] == 1, (f"{spec.name}: every megapass handle "
                                 f"must share ONE fetch, saw {c['n']}")
        new = leaves(ds_m.state)
        assert any(not _same_bits(s, n) for s, n in zip(snap, new)), \
            f"{spec.name}: the megapass never dispatched"
        # the port's donation: the dispatch consumed the old storage — it
        # wrote into it (in place), or the structure let it go (a pass
        # that writes a fresh block, as the map's merge must)
        assert any(r() is None or not _same_bits(s, r())
                   for r, s in zip(refs, snap)), \
            f"{spec.name}: the megapass must consume the state's storage"
    else:
        got = [h.result() for h in ds_m.mixed_rounds(rounds)]

    want = [h.result() for h in base(ds_s, rounds)]
    oracle_res = []
    for kind, m, i in rounds:
        if kind == "update":
            oracle_res.append(_oracle_update(oracle, m, i))
        else:
            oracle_res.append([oracle.apply(mm, ii)
                               for mm, ii in zip(m, i)])
    for (kind, m, i), g_r, w_r, o_r in zip(rounds, got, want, oracle_res):
        assert len(g_r) == len(w_r) == len(m), (spec.name, "megapass", kind)
        for mm, g, w, o in zip(m, g_r, w_r, o_r):
            assert spec.result_ok(mm, g, w), \
                (spec.name, "megapass vs sequential", mm, g, w)
            assert spec.result_ok(mm, g, o), \
                (spec.name, "megapass vs oracle", mm, g, o)
    if spec.dump_compare is not None:
        spec.dump_compare(ds_m, oracle)
        spec.dump_compare(ds_s, oracle)


# ---------------------------------------------------------------------------
# Placement parity: MeshPlacement ≡ StackedPlacement (DESIGN.md §18)
# ---------------------------------------------------------------------------
def _global_leaves(ds) -> List[torch.Tensor]:
    """Every state leaf in the stacked (K, …) layout (gathered from the
    mesh's ranks when placed)."""
    state = ds.global_state() if hasattr(ds, "global_state") else ds.state
    return leaves(state)


def check_placement_parity(spec: StructureSpec, *, seed: int = 53,
                           iters: int = 12) -> bool:
    """The reference's stage: a structure advertising
    ``supports_placement`` and its one-rank ``MeshPlacement`` twin (the
    current world's mesh; every collective still runs) take the SAME
    seeded traffic and must answer alike and land every state leaf
    bit-equal, refusals included (atomic on both sides), the fused
    megapass included, and fault-injected snapshot/restore included.  The
    class flag and the registry's marker must agree.  Returns False for
    structures without the flag."""
    from repro_torch.core.placement import MeshPlacement
    from repro_torch.launch.mesh import make_combining_mesh

    ds_s = make_cpu(spec)
    flag = bool(getattr(type(ds_s), "supports_placement", False))
    assert flag == bool(spec.extras.get("placement", False)), \
        f"{spec.name}: class flag and registry marker disagree"
    if not flag:
        return False
    n_shards = int(getattr(ds_s, "n_shards", 1))
    pl = MeshPlacement(make_combining_mesh(n_shards, device="cpu"))
    ds_m = make_cpu(spec, placement=pl)
    rng = np.random.default_rng(seed)
    ctx = spec.new_ctx()

    def states_agree(tag):
        for idx, (a, b) in enumerate(zip(_global_leaves(ds_s),
                                         _global_leaves(ds_m))):
            assert _same_bits(a, b), \
                (f"{spec.name}: placement twins diverged ({tag}, leaf "
                 f"{idx}, {pl.describe()})")

    for it in range(iters):
        k = int(rng.integers(0, 12))
        if rng.random() < 0.6:
            m, i = spec.gen_update(rng, k, ctx)
            got_s = ds_s.update_batch(list(m), list(i))
            got_m = ds_m.update_batch(list(m), list(i))
        else:
            m, i = spec.gen_read(rng, k, ctx)
            got_s = ds_s.read_batch(list(m), list(i))
            got_m = ds_m.read_batch(list(m), list(i))
        assert len(got_s) == len(got_m) == len(m)
        assert got_s == got_m, (spec.name, "placement parity", it)
        states_agree(f"iter {it}")

    if spec.refusal_batch is not None:
        bm, bi = spec.refusal_batch(ds_m)
        before = _fingerprint(ds_m)
        for twin in (ds_s, ds_m):
            with pytest.raises(ValueError):
                twin.update_batch(list(bm), list(bi))
        for b, a in zip(before, _fingerprint(ds_m)):
            np.testing.assert_array_equal(
                b, a, err_msg=f"{spec.name}: mesh refusal was not atomic")
        states_agree("post-refusal")

    gen_read = spec.extras.get("megapass_read", spec.gen_read)
    c_max = int(getattr(ds_s, "c_max", 8))
    rounds = []
    for r in range(4):
        k = int(rng.integers(1, c_max + 3))
        m, i = (spec.gen_update if r % 2 == 0 else gen_read)(rng, k, ctx)
        rounds.append(("update" if r % 2 == 0 else "read",
                       list(m), list(i)))
    got_s = [h.result() for h in ds_s.mixed_rounds(rounds)]
    got_m = [h.result() for h in ds_m.mixed_rounds(rounds)]
    assert got_s == got_m, (spec.name, "placement megapass parity")
    states_agree("post-megapass")

    plan = FaultPlan(seed=seed, dispatch_fail_rate=0.2)
    ds_f = make_cpu(spec, placement=pl, fault_plan=plan)
    run_differential(ds_f, spec.make_host(ds_f), spec,
                     np.random.default_rng(seed + 1), 25)
    assert plan.counters.faults_injected > 0, \
        f"{spec.name}: placement fault probe never fired — vacuous"
    assert plan.counters.snapshot()["restores"] > 0, \
        f"{spec.name}: mesh-placed failures were never rolled back"
    assert _global_leaves(ds_f)[0].shape == _global_leaves(ds_s)[0].shape
    return True


# ---------------------------------------------------------------------------
# Fault-plan exactly-once recovery (DESIGN.md §15)
# ---------------------------------------------------------------------------
def check_fault_exactly_once(spec: StructureSpec, *, seed: int = 0,
                             rate: float = 0.2, iters: int = 25) -> None:
    """The differential loop under injected dispatch failures: the
    transactional guard retries behind the scenes and the oracle never
    sees a lost or duplicated op."""
    plan = FaultPlan(seed=seed, dispatch_fail_rate=rate)
    ds = make_cpu(spec, fault_plan=plan)
    ds._guard._sleep = lambda s: None
    oracle = spec.make_host(ds)
    run_differential(ds, oracle, spec, np.random.default_rng(seed), iters)
    assert plan.counters.faults_injected > 0, \
        f"{spec.name}: the fault plan never fired — probe is vacuous"
    assert plan.counters.snapshot()["restores"] > 0, \
        f"{spec.name}: injected failures were never rolled back"


# ---------------------------------------------------------------------------
# Hypothesis rule-based state machine (generic over any spec)
# ---------------------------------------------------------------------------
def make_structure_machine(spec: StructureSpec,
                           factory: Optional[Callable[[], Any]] = None,
                           max_update: int = 13, max_read: int = 9):
    """A rule-based state machine driving ``spec``'s own generators under
    hypothesis' rule scheduling and shrinking; rules draw a seed and a
    width, so a failing schedule shrinks to a minimal seeded sequence."""
    seed_s = st.integers(0, 2**32 - 1)

    class StructureMachine(RuleBasedStateMachine):
        def __init__(self):
            super().__init__()
            self.ds = (factory or (lambda: make_cpu(spec)))()
            self.oracle = spec.make_host(self.ds)
            self.ctx = spec.new_ctx()

        @rule(seed=seed_s, k=st.integers(0, max_update))
        def update_batch(self, seed, k):
            rng = np.random.default_rng(seed)
            m, i = spec.gen_update(rng, k, self.ctx)
            got = _oracle_update(self.ds, m, i)
            want = _oracle_update(self.oracle, m, i)
            for mm, g, w in zip(m, got, want):
                assert spec.result_ok(mm, g, w), (mm, i, g, w)

        @rule(seed=seed_s, k=st.integers(0, max_read))
        def read_batch(self, seed, k):
            rng = np.random.default_rng(seed)
            m, i = spec.gen_read(rng, k, self.ctx)
            got = self.ds.read_batch(list(m), list(i))
            want = [self.oracle.apply(mm, ii) for mm, ii in zip(m, i)]
            for mm, g, w in zip(m, got, want):
                assert spec.result_ok(mm, g, w), (mm, i, g, w)

        @rule()
        def state_agrees(self):
            if spec.dump_compare is not None:
                spec.dump_compare(self.ds, self.oracle)

    StructureMachine.__name__ = f"{spec.name.title()}Machine"
    return StructureMachine


# ---------------------------------------------------------------------------
# The battery — every registered structure, zero per-structure code
# ---------------------------------------------------------------------------
@pytest.fixture(params=SPECS)
def spec(request):
    return substrate.get(request.param)


def test_registry_conformance(spec):
    ds = make_cpu(spec)
    assert substrate.conforms(ds), spec.name
    assert ds.structure == spec.name
    assert SPECS == ["graph", "map", "pq", "sketch", "unionfind"]


def test_differential(spec):
    check_differential(spec, seed=0, iters=30)


def test_differential_nodonate(spec):
    check_differential(spec, seed=1, iters=18,
                       make=lambda: make_cpu(spec, donate=False))


def test_one_sync(spec):
    check_one_sync(spec)


def test_donation(spec):
    check_donation(spec)


def test_atomic_refusal(spec):
    check_atomic_refusal(spec)


def test_rounds_equiv(spec):
    check_rounds_equiv(spec)


def test_megapass_vs_sequential(spec):
    check_megapass_vs_sequential(spec)


@pytest.fixture
def one_rank_world():
    """The one-rank process group ``make_combining_mesh`` starts, torn
    down after the test so no group outlives it in the worker."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def test_placement_parity(spec, one_rank_world):
    assert check_placement_parity(spec) == (spec.name in ("graph", "map",
                                                          "pq"))


@pytest.mark.faults
def test_fault_exactly_once(spec):
    check_fault_exactly_once(spec)


@pytest.mark.fuzz
def test_structure_machine(spec):
    machine = make_structure_machine(spec)
    machine.TestCase.settings = settings(
        max_examples=4, stateful_step_count=6, deadline=None,
        derandomize=True, suppress_health_check=list(HealthCheck))
    machine.TestCase().runTest()


def test_pq_is_fused():
    """The PQ's megapass landed: class flag and registry agree on it."""
    spec = substrate.get("pq")
    assert spec.megapass and type(make_cpu(spec)).supports_megapass
    assert "megapass_read" in spec.extras


# ---------------------------------------------------------------------------
# Broken toys — each defect is caught by the stage that owns the contract
# ---------------------------------------------------------------------------
def _sketch_spec():
    return substrate.get("sketch")


def _stale_guard_sketch():
    """Toy defect: the occupancy guard never consults (or grows) the host
    mirror — an overflowing batch sails through."""
    from repro_torch.core.batched_sketch import ShardedSketch

    class Broken(ShardedSketch):
        def _guard_slices(self, slices):
            return          # forgot the mirror entirely

    return Broken(64, c_max=8, n_shards=2, device="cpu")


def test_battery_catches_stale_guard():
    with pytest.raises(AssertionError, match="accepted instead"):
        check_atomic_refusal(_sketch_spec(), make=_stale_guard_sketch)


def _double_fetch_sketch():
    """Toy defect: the read path fetches twice."""
    from repro_torch.core import batched_sketch as _mod
    from repro_torch.core.batched_sketch import ShardedSketch

    class Broken(ShardedSketch):
        def read_batch(self, methods, inputs):
            out = super().read_batch(methods, inputs)
            _mod._host_fetch(self.state.size + 0)   # the extra sync
            return out

    return Broken(512, c_max=8, n_shards=2, device="cpu")


def test_battery_catches_double_fetch():
    with pytest.raises(AssertionError, match="ONE fetch"):
        check_one_sync(_sketch_spec(), make=_double_fetch_sketch)


def _non_atomic_refusal_sketch():
    """Toy defect: the guard grows the mirror slice by slice and raises
    midway WITHOUT restoring — a refused batch corrupts the mirror."""
    from repro_torch.core.batched_sketch import (ShardedSketch,
                                                 route_hash_host)

    class Broken(ShardedSketch):
        def _guard_slices(self, slices):
            for opk, nc in slices:
                if nc:
                    shards = route_hash_host(opk[:nc], self.n_shards)
                    # defect: mutates the LIVE mirror slice by slice
                    self._sizes_ub = self._sizes_ub + np.bincount(
                        shards, minlength=self.n_shards).astype(np.int64)
                if np.any(self._sizes_ub > self.capacity):
                    raise ValueError("per-shard capacity exceeded")

    return Broken(64, c_max=8, n_shards=2, device="cpu")


def test_battery_catches_non_atomic_refusal():
    with pytest.raises(AssertionError, match="not atomic"):
        check_atomic_refusal(_sketch_spec(), make=_non_atomic_refusal_sketch)


def _stale_mirror_map():
    """Toy defect: reads never re-tighten the occupancy upper bound, so
    the guard drifts conservative until it refuses legal batches."""
    from repro_torch.core.batched_map import ShardedMap

    class Broken(ShardedMap):
        def _refresh_sizes(self, sizes):
            return          # mirror never re-tightens

    return Broken(24, c_max=8, n_shards=4, key_range=(0.0, 100.0),
                  device="cpu")


def test_battery_catches_stale_mirror():
    # every insert grows the bound forever; with capacity 24 the
    # differential loop's legal schedule draws a spurious refusal
    with pytest.raises(ValueError, match="capacity"):
        check_differential(substrate.get("map"), seed=3, iters=200,
                           make=_stale_mirror_map)


def _read_first_map():
    """Toy defect: the fused lowering dispatches every READ round before
    any UPDATE round — the serial schedule is broken."""
    from repro_torch.core.batched_map import ShardedMap

    class Broken(ShardedMap):
        def mixed_rounds(self, rounds):
            order = sorted(range(len(rounds)),
                           key=lambda j: rounds[j][0] != "read")
            hs = super().mixed_rounds([rounds[j] for j in order])
            out = [None] * len(rounds)
            for pos, j in enumerate(order):
                out[j] = hs[pos]
            return out

    return Broken(2048, c_max=16, n_shards=4, key_range=(0.0, 1000.0),
                  device="cpu")


def test_battery_catches_read_ordering_defect():
    with pytest.raises(AssertionError, match="megapass"):
        check_megapass_vs_sequential(substrate.get("map"),
                                     make=_read_first_map)


def _unfused_pq():
    """Toy defect: the PQ keeps its flag but rides the base fallback."""
    from repro_torch.core.sharded_pq import ShardedBatchedPQ

    class Broken(ShardedBatchedPQ):
        mixed_rounds = substrate.BatchedStructure.mixed_rounds

    return Broken(512, c_max=8, n_shards=2, device="cpu")


def test_battery_catches_a_flag_that_lies():
    with pytest.raises(AssertionError, match="flag contradicts"):
        check_megapass_vs_sequential(substrate.get("pq"), make=_unfused_pq)


def test_count_fetches_is_restored():
    """The counting hook restores the module's fetch on exit."""
    spec = _sketch_spec()
    mod = importlib.import_module(spec.module)
    orig = mod._host_fetch
    with count_fetches(spec) as c:
        assert mod._host_fetch is not orig
    assert mod._host_fetch is orig
    assert c["n"] == 0


def test_run_differential_rejects_result_drift():
    """An oracle that lies about one result fails the loop."""
    spec = _sketch_spec()

    class LyingOracle:
        def __init__(self, real):
            self.real = real

        def update_batch(self, methods, inputs):
            out = self.real.update_batch(methods, inputs)
            return [not r if isinstance(r, bool) else r for r in out]

        def apply(self, m, i):
            return self.real.apply(m, i)

        def items(self):
            return self.real.items()

    ds = make_cpu(spec)
    oracle = LyingOracle(spec.make_host(ds))
    with pytest.raises(AssertionError):
        run_differential(ds, oracle, spec, np.random.default_rng(0), 10,
                         update_frac=1.0)
