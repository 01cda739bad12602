"""The port's placement layer (DESIGN.md §18) across spawned gloo ranks.

One spawned job a world size (``torch.multiprocessing``, the spawn
start method, a ``FileStore`` under ``tmp_path``, one thread a rank) runs
every case of that world on every rank, SPMD: K = 4 shards over 2 ranks,
and K = 8 over 4.

- parity: each rank drives the port's stacked twin and its mesh twin of
  ``pq``, ``map`` and ``graph`` with one seeded stream; answers are equal
  and the gathered mesh state is bit-equal to the stacked state after
  every batch, refusals (atomic) and the megapass included;
- each rank holds exactly K / D rows, and the PQ's in-place passes keep
  the rows' storage (``data_ptr``);
- injected dispatch faults are restored with the rows still placed;
- the constructor rejects K = 6 over 4 ranks; ``make_combining_mesh``'s
  largest-divisor rule; ``make_mesh_for_world``'s shapes and error;
- the threaded front ends run under a mesh of more than one rank: the
  leader (mesh index 0) combines and serves, the other ranks follow its
  dispatches (``tests/test_torch_combining_ranks.py`` holds them to the
  JAX package).

Every job has its own limit: a gloo timeout at init, and a join with a
deadline that kills the ranks and fails the test, so a hung collective
cannot stall the suite.  This file imports neither JAX nor the JAX
package: the spawned ranks import it.
"""
import datetime
import os
import queue
import time
import traceback

import numpy as np
import pytest
import torch

JOB_S = 240            # a whole spawned job, start to join
GLOO_S = 60            # a single collective
WORLDS = {2: 4, 4: 8}  # world size -> K
PLACED = ("pq", "map", "graph")


# ---------------------------------------------------------------------------
# The cases (run inside every rank; each returns a small dict)
# ---------------------------------------------------------------------------
def _pl(k):
    from repro_torch.core.placement import MeshPlacement
    from repro_torch.launch.mesh import make_combining_mesh

    return MeshPlacement(make_combining_mesh(k, device="cpu"))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def case_parity(name, world, k):
    """Stacked and mesh twins on one stream: answers and the gathered
    state bit-equal after every batch, then refusal and megapass."""
    from repro_torch.core import substrate

    substrate.load_builtins()
    spec = substrate.get(name)
    pl = _pl(k)
    assert pl.n_devices == world
    ds_s = spec.make(n_shards=k, device="cpu")
    ds_m = spec.make(n_shards=k, placement=pl)
    rng = np.random.default_rng(100 + world)
    ctx = spec.new_ctx()
    for it in range(10):
        n = int(rng.integers(0, 11))
        if rng.random() < 0.6:
            m, i = spec.gen_update(rng, n, ctx)
            got_s = ds_s.update_batch(m, i)
            got_m = ds_m.update_batch(m, i)
        else:
            m, i = spec.gen_read(rng, n, ctx)
            got_s = ds_s.read_batch(m, i)
            got_m = ds_m.read_batch(m, i)
        assert got_s == got_m, (name, it, got_s, got_m)
        assert _same(ds_s.state, ds_m.global_state()), (name, it)
    bm, bi = spec.refusal_batch(ds_m)
    before = [t.clone() for t in ds_m.state]
    for twin in (ds_s, ds_m):
        try:
            twin.update_batch(bm, bi)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name}: refusal probe accepted")
    assert _same(before, ds_m.state), f"{name}: refusal not atomic"
    gen_read = spec.extras.get("megapass_read", spec.gen_read)
    rounds = []
    for r in range(4):
        m, i = (spec.gen_update if r % 2 == 0 else gen_read)(
            rng, int(rng.integers(1, 10)), ctx)
        rounds.append(("update" if r % 2 == 0 else "read", m, i))
    got_s = [h.result() for h in ds_s.mixed_rounds(rounds)]
    got_m = [h.result() for h in ds_m.mixed_rounds(rounds)]
    assert got_s == got_m, (name, "megapass")
    assert _same(ds_s.state, ds_m.global_state()), (name, "megapass")
    return {"len": len(ds_m), "rows": [int(t.shape[0]) for t in ds_m.state
                                      if t.dim()]}


def case_rows(world, k):
    """K / D rows a rank, and the PQ's in-place passes keep the rows'
    storage; the map's rows are K / D after its (new-block) merges."""
    from repro_torch.core.batched_map import ShardedMap
    from repro_torch.core.sharded_pq import ShardedBatchedPQ

    pl = _pl(k)
    pq = ShardedBatchedPQ(256, 4, n_shards=k, values=np.arange(50.0),
                          placement=pl)
    ptrs = (pq.state.a.data_ptr(), pq.state.size.data_ptr())
    assert pq.state.a.shape == (k // world, 256)
    got = []
    for r in range(6):
        got += pq.apply(3, [100.0 + r, 0.5 * r])
    for answers in pq.apply_rounds([(2, [7.0]), (1, [])]):
        got += answers
    assert (pq.state.a.data_ptr(), pq.state.size.data_ptr()) == ptrs
    mp = ShardedMap(64, 4, n_shards=k, key_range=(0.0, 100.0),
                    items=[(float(x), 1.0) for x in range(0, 100, 3)],
                    placement=pl)
    mp.update_batch(["insert", "delete"], [(50.5, 2.0), 3.0])
    assert all(t.shape[0] == k // world for t in mp.state)
    return {"answers": got, "map_len": len(mp)}


def case_restore(name, world, k):
    """Injected dispatch failures on the mesh twin are rolled back and
    retried: the answers equal a fault-free stacked twin's, and the state
    stays placed."""
    from repro_torch.core import substrate
    from repro_torch.core.faults import FaultPlan

    substrate.load_builtins()
    spec = substrate.get(name)
    plan = FaultPlan(seed=5, dispatch_fail_rate=0.3)
    ds_f = spec.make(n_shards=k, placement=_pl(k), fault_plan=plan)
    ds_s = spec.make(n_shards=k, device="cpu")
    rng = np.random.default_rng(5)
    ctx = spec.new_ctx()
    for it in range(12):
        m, i = spec.gen_update(rng, int(rng.integers(1, 9)), ctx)
        assert ds_f.update_batch(m, i) == ds_s.update_batch(m, i), it
        m, i = spec.gen_read(rng, 3, ctx)
        assert ds_f.read_batch(m, i) == ds_s.read_batch(m, i), it
    assert _same(ds_s.state, ds_f.global_state())
    restores = plan.counters.snapshot()["restores"]
    assert restores > 0, "the plan never rolled back: vacuous"
    if name != "graph":
        assert ds_f.state[0].shape[0] == k // world
    return {"restores": restores}


def case_indivisible(world, k):
    """K = 6 over a hand-built mesh of every rank: refused."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.batched_map import ShardedMap
    from repro_torch.core.placement import MeshPlacement
    from repro_torch.core.sharded_pq import ShardedBatchedPQ

    pl = MeshPlacement(DeviceMesh("cpu", list(range(world)),
                                  mesh_dim_names=("shard",)))
    refused = []
    for make in (lambda: ShardedBatchedPQ(64, 4, n_shards=6, placement=pl),
                 lambda: ShardedMap(64, 4, n_shards=6, key_range=(0.0, 1.0),
                                    placement=pl)):
        try:
            make()
        except ValueError as e:
            refused.append("divisible" in str(e))
    return {"refused": refused}


def case_mesh_rules(world, k):
    """make_combining_mesh's largest-divisor rule (ranks and explicit rank
    lists), make_mesh_for_world's shapes and error, mesh_axes."""
    from repro_torch.launch.mesh import (make_combining_mesh,
                                         make_mesh_for_world, mesh_axes)

    sizes = {}
    for kk in (1, 2, 3, 4, 6, 8):
        mesh = make_combining_mesh(kk, device="cpu")
        assert mesh.mesh_dim_names == ("shard",)
        sizes[kk] = mesh.shape[0]
    explicit = {}
    for kk, ranks in ((6, range(world)), (8, range(world)),
                      (4, range(min(3, world))), (6, [0])):
        explicit[(kk, len(list(ranks)))] = make_combining_mesh(
            kk, devices=list(ranks), device="cpu").shape[0]
    shapes = {}
    for kw in (dict(), dict(model_parallel=2), dict(model_parallel=2,
                                                    pods=world // 2)):
        m = make_mesh_for_world(world, device="cpu", **kw)
        shapes[tuple(sorted(kw.items()))] = (tuple(m.shape),
                                             tuple(m.mesh_dim_names),
                                             mesh_axes(m))
    try:
        make_mesh_for_world(world, model_parallel=3, device="cpu")
        error = None
    except ValueError as e:
        error = str(e)
    return {"sizes": sizes, "explicit": explicit, "shapes": shapes,
            "error": error}


def case_threaded(world, k):
    """The threaded front ends on a mesh of every rank: the leader's
    combiner, scheduler and sessions run, the other ranks follow."""
    from repro_torch.core.pc_pq import pc_sharded_priority_queue
    from repro_torch.launch import serve
    from repro_torch.serving import PCScheduler

    pl = _pl(k)
    got = {"leader": pl.is_leader}
    q = pc_sharded_priority_queue(64, 4, n_shards=k, values=[9.0],
                                  placement=pl, device="cpu")
    if pl.is_leader:
        got["pq"] = [q.execute("insert", 3.0), q.execute("extract_min")]
        q.close()
    else:
        q.follow()
    # each front end is followed to its close before the next one's
    # groups are made (every rank makes those, in the same order)
    sch = PCScheduler(lambda rows: [r + 1 for r in rows], n_shards=k,
                      pq_placement=pl, device="cpu")
    if pl.is_leader:
        got["sched"] = sch.submit_async(5, deadline=1.0).result(timeout=30)
        sch.close()
    else:
        sch.follow()
    got["serve"] = serve.run_serving(workload="pq", mesh_shards=k,
                                     sessions=2, requests_per_session=2,
                                     device="cpu")
    return got


def _cases(world, k):
    out = [(f"parity-{n}", lambda n=n: case_parity(n, world, k))
           for n in PLACED]
    out += [("rows", lambda: case_rows(world, k))]
    out += [(f"restore-{n}", lambda n=n: case_restore(n, world, k))
            for n in ("pq", "map")]
    out += [("indivisible", lambda: case_indivisible(world, k)),
            ("mesh-rules", lambda: case_mesh_rules(world, k)),
            ("threaded", lambda: case_threaded(world, k))]
    return out


# ---------------------------------------------------------------------------
# The spawned job
# ---------------------------------------------------------------------------
def _rank_main(rank, world, store, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    results = {}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=GLOO_S))
        for name, run in _cases(world, WORLDS[world]):
            try:
                results[name] = ("ok", run())
            except Exception:
                results[name] = ("error", traceback.format_exc())
                break          # the ranks are out of step from here on
    except Exception:
        results["init"] = ("error", traceback.format_exc())
    finally:
        q.put((rank, results))
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_job(world, tmp):
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, q),
                         daemon=True) for r in range(world)]
    deadline = time.monotonic() + JOB_S
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, res = q.get(timeout=min(left, 5.0))
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and q.empty():
                    break
                continue
            got[rank] = res
    finally:
        for p in procs:
            p.join(max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return got


@pytest.fixture(scope="module", params=sorted(WORLDS), ids=lambda w: f"D{w}")
def job(request, tmp_path_factory):
    world = request.param
    t0 = time.monotonic()
    got = _run_job(world, str(tmp_path_factory.mktemp(f"world{world}")))
    return world, WORLDS[world], got, time.monotonic() - t0


def _result(job, case):
    """The case's result on every rank; fails the test (with the rank's
    traceback) when a rank did not finish it."""
    world, k, got, seconds = job
    assert seconds < JOB_S + 30, f"job ran {seconds:.0f} s"
    missing = [r for r in range(world) if r not in got]
    assert not missing, f"ranks {missing} sent nothing before the deadline"
    out = []
    for r in range(world):
        status, val = got[r].get(case, got[r].get("init", ("error",
                                                           "not run")))
        assert status == "ok", f"rank {r}, {case}:\n{val}"
        out.append(val)
    return world, k, out


# ---------------------------------------------------------------------------
# The tests: each reads its case from the world's one job
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", PLACED)
def test_mesh_twin_bit_equal_to_stacked(job, name):
    world, k, res = _result(job, f"parity-{name}")
    assert all(r == res[0] for r in res)          # every rank agrees
    if name != "graph":
        assert res[0]["rows"] == [k // world] * len(res[0]["rows"])


def test_rows_a_rank_and_in_place_storage(job):
    world, k, res = _result(job, "rows")
    assert all(r == res[0] for r in res)
    assert len(res[0]["answers"]) == 21
    assert res[0]["answers"][:3] == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("name", ["pq", "map"])
def test_restore_keeps_the_placement(job, name):
    _world, _k, res = _result(job, f"restore-{name}")
    assert all(r["restores"] > 0 for r in res)


def test_ctor_rejects_indivisible_k(job):
    world, _k, res = _result(job, "indivisible")
    want = [True, True] if 6 % world else []
    assert all(r["refused"] == want for r in res), res


def test_make_combining_mesh_divisor_rule(job):
    world, _k, res = _result(job, "mesh-rules")
    r = res[0]
    assert all(x == r for x in res)
    for kk, d in r["sizes"].items():
        assert kk % d == 0
        assert not any(kk % g == 0 for g in range(d + 1,
                                                  min(world, kk) + 1))
    want = {(6, world): 3 if world == 4 else 2, (8, world): world,
            (4, min(3, world)): 2, (6, 1): 1}
    assert r["explicit"] == want


def test_make_mesh_for_world_shapes_and_error(job):
    world, _k, res = _result(job, "mesh-rules")
    shapes = res[0]["shapes"]
    assert shapes[()] == ((world, 1), ("data", "model"),
                          (("data",), "model", None))
    assert shapes[(("model_parallel", 2),)] == (
        (world // 2, 2), ("data", "model"), (("data",), "model", None))
    pods = world // 2
    want = (((pods, 1, 2), ("pod", "data", "model"),
             (("pod", "data"), "model", "pod")) if pods > 1 else
            ((1, 2), ("data", "model"), (("data",), "model", None)))
    assert shapes[(("model_parallel", 2), ("pods", pods))] == want
    assert "not divisible by model=3" in res[0]["error"]


def test_threaded_front_ends_run_on_a_larger_mesh(job):
    world, _k, res = _result(job, "threaded")
    assert res[0]["leader"] and not any(r["leader"] for r in res[1:])
    assert res[0]["pq"] == [None, 3.0] and res[0]["sched"] == 6
    stats = res[0]["serve"]
    assert stats["mesh_devices"] == world and stats["requests"] == 4
    assert all(r["serve"] == stats for r in res)
