"""The port's placement layer (DESIGN.md §18) against the JAX package's,
in one process on the CPU: a world of one rank, so every mesh is D = 1.

- The layer itself (``core/placement.py``, ``launch/mesh.py``): the
  reference's ``tests/test_placement.py`` cases that a one-rank world
  runs — the stacked default, junk refused, the axis check, the
  divisibility rule, the largest-divisor rule, the placed set pinned to
  the registry.
- Parity with the reference: the same seeded op stream (the reference's
  ``_drive_twins``) goes through the port's ``MeshPlacement`` twin of
  ``pq``, ``map`` and ``graph`` (a gloo group of one rank; every
  collective runs) and through the JAX package's
  ``MeshPlacement(make_combining_mesh(4))`` twin (``shard_map`` on the
  one CPU device).  Answers are equal (the map's ``range_sum`` within
  the reference's ``_result_ok`` tolerance: the two packages' prefix sums
  add in other orders), every state leaf bit-equal, after every batch;
  then refusal atomicity, the megapass, and injected dispatch faults with
  their restores, against the JAX twin under the same fault plan.

The spawned-rank cases (D = 2 and D = 4) are in
``tests/test_torch_placement_ranks.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import placement as jplacement
from repro.core import substrate as jsub
from repro.core.faults import FaultPlan as JFaultPlan
from repro.launch.mesh import make_combining_mesh as j_combining_mesh
from repro_torch.core import placement
from repro_torch.core import substrate
from repro_torch.core.faults import FaultPlan
from repro_torch.launch.mesh import make_combining_mesh, mesh_axes

substrate.load_builtins()
jsub.load_builtins()

# the structures whose constructors take placement=, as in the reference
PLACED = ["pq", "map", "graph"]


@pytest.fixture
def world():
    """The one-rank process group ``make_combining_mesh`` starts, torn
    down after the test so no group outlives it in the xdist worker."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_pl(k=4):
    return placement.MeshPlacement(make_combining_mesh(k, device="cpu"))


# ---------------------------------------------------------------------------
# The placement layer itself
# ---------------------------------------------------------------------------
def test_resolve_placement_default():
    pl = placement.resolve_placement(None)
    assert isinstance(pl, placement.StackedPlacement)
    assert not pl.is_mesh and pl.n_devices == 1
    assert placement.as_static(pl) is None
    pl.validate(7)                                  # any K is fine
    tree = {"a": np.arange(4)}
    assert pl.put(tree) is tree and pl.gather(tree) is tree
    assert pl.describe() == "stacked"
    assert pl.comm() is placement.STACKED
    t = torch.arange(3)
    assert placement.STACKED.gather(t) is t and placement.STACKED.sum(t) is t
    hash(pl)


def test_resolve_placement_rejects_junk():
    for junk in ("mesh", object(), 4):
        with pytest.raises(TypeError, match="not a placement"):
            placement.resolve_placement(junk)


def test_mesh_placement_axis_validation(world):
    mesh = make_combining_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="axes"):
        placement.MeshPlacement(mesh, axis="nope")
    pl = placement.MeshPlacement(mesh)
    assert pl.is_mesh and pl.axis == "shard"
    assert pl.n_devices == mesh.shape[0] == 1
    assert placement.as_static(pl) is pl
    assert pl.describe() == jplacement.MeshPlacement(
        j_combining_mesh(4)).describe() == "mesh(D=1, axis='shard')"
    assert pl.index == 0 and pl.ranks == [0] and pl.device.type == "cpu"
    hash(pl)


def test_mesh_placement_divisibility_put_and_gather(world):
    pl = mesh_pl()
    pl.validate(4 * pl.n_devices)
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    size = np.arange(4, dtype=np.int32)
    la, ls = pl.put((a, size), 4)                   # D = 1: every row
    assert np.array_equal(la, a) and np.array_equal(ls, size)
    la, ls = torch.from_numpy(la), torch.from_numpy(ls)
    assert torch.equal(pl.put(la, 4), la)
    comm = pl.comm()
    ga, gs = pl.gather((la, ls), comm)
    assert torch.equal(ga, la) and torch.equal(gs, ls)
    mask = torch.tensor([True, False, True])
    assert torch.equal(comm.gather(mask), mask)     # bools ride as uint8
    assert int(comm.sum(torch.tensor(5))) == 5
    assert float(comm.min(torch.tensor([2.5]))) == 2.5


def test_make_combining_mesh_divisor_rule(world):
    """D = the largest divisor of n_shards that fits the world (one rank
    here); a 1-D ("shard",) mesh."""
    for k in (1, 2, 3, 4, 6, 8):
        mesh = make_combining_mesh(k, device="cpu")
        assert mesh.mesh_dim_names == ("shard",)
        assert mesh.shape == (1,)
    assert make_combining_mesh(6, devices=[0], device="cpu").shape == (1,)
    with pytest.raises(ValueError):
        make_combining_mesh(0, device="cpu")
    assert mesh_axes(make_combining_mesh(2, device="cpu")) == ((), "model",
                                                              None)


def test_placed_set_matches_registry():
    """The class attribute, the registry marker serve.py keys
    --mesh-shards off, the reference's marker and PLACED agree."""
    for name in sorted(substrate.names()):
        spec = substrate.get(name)
        ds = spec.make(device="cpu")
        assert getattr(ds, "supports_placement", False) == (name in PLACED)
        assert bool(spec.extras.get("placement")) == (name in PLACED), name
        assert bool(jsub.get(name).extras.get("placement")) == \
            (name in PLACED), name


@pytest.mark.parametrize("name", PLACED)
def test_device_must_agree_with_the_mesh(name, world):
    pl = mesh_pl()
    ds = substrate.get(name).make(n_shards=4, placement=pl)
    assert ds.device.type == "cpu"                  # the mesh's device
    with pytest.raises(ValueError, match="disagrees"):
        substrate.get(name).make(n_shards=4, placement=pl, device="meta")


# ---------------------------------------------------------------------------
# Parity with the JAX package's mesh twin (D = 1)
# ---------------------------------------------------------------------------
def _jax_leaves(ds):
    st = ds.state
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _torch_leaves(ds):
    st = ds.global_state()
    return {f: getattr(st, f).numpy() for f in st._fields}


def assert_states_equal(jds, tds, where):
    want, got = _jax_leaves(jds), _torch_leaves(tds)
    for field, w in want.items():
        np.testing.assert_array_equal(
            got[field], w, err_msg=f"{where}: state leaf {field}")
        assert got[field].dtype == w.dtype or field == "size", \
            (where, field, got[field].dtype, w.dtype)


def assert_answers(spec, methods, got, want, where):
    assert len(got) == len(want) == len(methods), where
    for m, g, w in zip(methods, got, want):
        if m == "range_sum":
            assert spec.result_ok(m, g, w), (where, m, g, w)
        else:
            assert g == w, (where, m, g, w)


def _twins(name, k_shards=4, **kw):
    tpl = mesh_pl(k_shards)
    jpl = jplacement.MeshPlacement(j_combining_mesh(k_shards))
    tds = substrate.get(name).make(n_shards=k_shards, placement=tpl, **kw)
    jkw = dict(kw)
    if "fault_plan" in kw:
        jkw["fault_plan"] = JFaultPlan(seed=kw["fault_plan"].seed,
                                       dispatch_fail_rate=0.2)
    jds = jsub.get(name).make(n_shards=k_shards, placement=jpl, **jkw)
    return substrate.get(name), jds, tds


def _drive(spec, jds, tds, rng, ctx, iters, where):
    """The reference's ``_drive_twins`` loop: one seeded batch a step,
    generated once and applied to both twins."""
    for it in range(iters):
        k = int(rng.integers(0, 11))
        if rng.random() < 0.6:
            m, i = spec.gen_update(rng, k, ctx)
            want = jds.update_batch(list(m), list(i))
            got = tds.update_batch(list(m), list(i))
        else:
            m, i = spec.gen_read(rng, k, ctx)
            want = jds.read_batch(list(m), list(i))
            got = tds.read_batch(list(m), list(i))
        assert_answers(spec, m, got, want, f"{where} iter {it}")
        assert_states_equal(jds, tds, f"{where} iter {it}")


@pytest.mark.parametrize("name", PLACED)
def test_parity_with_the_reference_mesh_twin(name, world):
    spec, jds, tds = _twins(name)
    assert tds.placement.is_mesh and jds.placement.is_mesh
    assert_states_equal(jds, tds, "init")
    rng = np.random.default_rng(404)
    ctx = spec.new_ctx()
    _drive(spec, jds, tds, rng, ctx, 16, name)

    # refusal atomicity: both twins refuse, the port's state stays
    # bit-identical (and equal to the reference's)
    bm, bi = spec.refusal_batch(tds)
    before = {f: v.copy() for f, v in _torch_leaves(tds).items()}
    mirror = {k: np.array(v, copy=True)
              for k, v in tds.occupancy_mirror().items()}
    for twin in (jds, tds):
        with pytest.raises(ValueError):
            twin.update_batch(list(bm), list(bi))
    for f, v in _torch_leaves(tds).items():
        np.testing.assert_array_equal(v, before[f], err_msg=f"refusal {f}")
    for k, v in tds.occupancy_mirror().items():
        np.testing.assert_array_equal(np.asarray(v), mirror[k])
    assert_states_equal(jds, tds, "post-refusal")

    # megapass parity: one fused dispatch each over the same rounds
    gen_read = spec.extras.get("megapass_read", spec.gen_read)
    rounds = []
    for r in range(4):
        kk = int(rng.integers(1, 10))
        m, i = (spec.gen_update if r % 2 == 0 else gen_read)(rng, kk, ctx)
        rounds.append(("update" if r % 2 == 0 else "read",
                       list(m), list(i)))
    want = [h.result() for h in jds.mixed_rounds(rounds)]
    got = [h.result() for h in tds.mixed_rounds(rounds)]
    for (kind, m, _), g, w in zip(rounds, got, want):
        assert_answers(spec, m, g, w, f"megapass {kind}")
    assert_states_equal(jds, tds, "post-megapass")


@pytest.mark.parametrize("name", PLACED)
def test_fault_restore_parity_with_the_reference(name, world):
    """Injected dispatch failures on both mesh twins (the same seeded
    plan): the guards restore and retry behind the scenes, the answers,
    the states and the fault counters stay equal, and the port's rows
    stay placed (local tensors of the mesh's device, K rows at D = 1)."""
    spec, jds, tds = _twins(name, fault_plan=FaultPlan(seed=5,
                                                       dispatch_fail_rate=0.2))
    rng = np.random.default_rng(5)
    _drive(spec, jds, tds, rng, spec.new_ctx(), 25, f"{name} faults")
    tc = tds.fault_plan.counters.snapshot()
    jc = jds.fault_plan.counters.snapshot()
    assert tc["restores"] > 0, "the plan never rolled back: vacuous"
    assert tc == jc
    for t in tds.state:
        assert t.device.type == "cpu"
    if name != "graph":
        assert tds.state[0].shape[0] == 4


def test_connected_components_placement_matches_the_reference(world):
    """``label_prop.connected_components(placement=)``: the block-and-star
    collective rebuild equals the JAX package's ``_cc_collective`` and the
    stacked rebuild, edge counts that do and do not divide."""
    from repro.kernels.label_prop import ops as jops
    from repro_torch.kernels.label_prop import ops as tops

    rng = np.random.default_rng(3)
    pl = mesh_pl()
    jpl = jplacement.MeshPlacement(j_combining_mesh(4))
    for n, e in ((1, 1), (17, 9), (64, 40), (200, 333)):
        eu = rng.integers(0, n, e).astype(np.int32)
        ev = rng.integers(0, n, e).astype(np.int32)
        got = tops.connected_components(torch.from_numpy(eu),
                                        torch.from_numpy(ev), n=n,
                                        placement=pl)
        stacked = tops.connected_components(torch.from_numpy(eu),
                                            torch.from_numpy(ev), n=n)
        want = np.asarray(jops.connected_components(eu, ev, n=n,
                                                    placement=jpl))
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, stacked)


def test_graph_mesh_read_gathers_only_when_a_rebuild_may_run(world):
    """The mesh twin of ``DeviceGraph`` runs its collective rebuild only
    when the host's bound allows a full rebuild (a delete lane, inserts
    that may overflow the pending buffer, a state the passes did not
    leave): insert-only reads gather nothing, through both the read pass
    and the megapass, and every answer and state leaf stays the stacked
    twin's."""
    from repro_torch.core.device_graph import DeviceGraph

    kw = dict(edge_capacity=256, c_max=8)
    st = DeviceGraph(32, device="cpu", **kw)
    mh = DeviceGraph(32, placement=mesh_pl(), **kw)
    gathers = []
    gather = mh._comm.gather
    mh._comm.gather = lambda t: gathers.append(t.shape) or gather(t)
    rng = np.random.default_rng(11)
    q = [(int(rng.integers(32)), int(rng.integers(32))) for _ in range(6)]

    def step(methods, edges, want_gathers):
        before = len(gathers)
        got = [(g.update_batch(methods, edges), g.connected_batch(q))
               for g in (st, mh)]
        assert got[0] == got[1]
        assert all(torch.equal(a, b) for a, b in zip(st.state, mh.state))
        assert len(gathers) - before == want_gathers, (methods, edges)

    step(["insert"], [(0, 1)], 1)          # a new graph: bound raised
    step(["insert"] * 3, [(1, 2), (3, 4), (5, 6)], 0)
    step(["delete", "insert"], [(3, 4), (7, 8)], 1)
    step(["insert"] * 17, [(i, i + 1) for i in range(9, 26)], 1)
    step(["insert"], [(2, 3)], 0)
    rounds = [("update", ["insert"], [(4, 5)]), ("read", ["connected"], q),
              ("update", ["delete"], [(0, 1)]), ("read", ["connected"], q)]
    before = len(gathers)
    got = []
    for g in (st, mh):
        hs = g.mixed_rounds(rounds)
        got.append([h.result() for h in hs])
    assert got[0] == got[1]
    assert all(torch.equal(a, b) for a, b in zip(st.state, mh.state))
    assert len(gathers) - before == 1
    assert mh.full_rebuilds() == st.full_rebuilds() == 3
