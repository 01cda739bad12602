"""The threaded front ends on a mesh of more than one rank (DESIGN.md §18).

One rank, the mesh's index 0 (the leader), runs the combiner, its client
threads and the scheduler; every other rank follows the leader's
dispatches on its own shard rows (``core.placement.DispatchChannel``).
One spawned job a world size, on the harness of
``tests/test_torch_placement_ranks.py`` (``torch.multiprocessing`` spawn,
a ``FileStore`` under ``tmp_path``, a gloo timeout, a job deadline that
kills the ranks): K = 4 over 2 ranks, and K = 8 over 4.  Each case runs
on every rank and returns what the parent checks, against the JAX
package where it has the same function:

- ``pc_sharded_priority_queue(placement=)`` under 4 client threads on
  the leader: its passes, logged, replayed through the port's stacked
  ``ShardedBatchedPQ`` and the JAX ``ShardedBatchedPQ`` (the XLA path)
  give the leader's answers bit for bit; every rank's rows are those
  replays' rows for its index, the leader's gathered heaps too; the
  multiset is conserved; the channel sent one record a pass;
- ``PCScheduler(pq_placement=)``: a published stream through ``_order``
  chooses what the JAX scheduler chooses, pass by pass, and the ranks'
  rows are its deadline PQ's; a threaded scheduler with a combiner kill
  serves every request once, and the followers follow the rebuilt queue;
- ``run_serving(mesh_shards=K)`` on ``pq``, ``map``, ``graph`` and
  ``decode``: every request executed once, the reference's stats keys,
  ``mesh_devices`` = D, the same stats on every rank; and so under the
  standard fault plan, with a takeover and (but on decode, whose deadline
  PQ elimination spares every dispatch) a restore, every rank's rows
  of the pq and map workloads equal to a fault-free stacked replay of
  the leader's records, the graph's replicated state the leader's;
- a follower's ``execute`` and ``submit_async`` raise, naming the leader.

And in this process, at D = 1: the leader's PQ pass still makes exactly
one blocking fetch with the channel running.

The spawned ranks import neither JAX nor the JAX package; the parent
runs the JAX replays from the ranks' returned logs.
"""
import datetime
import os
import queue
import threading
import time
import traceback
from collections import Counter

import numpy as np
import pytest
import torch

JOB_S = 150            # a whole spawned job, start to join
GLOO_S = 60            # a single collective
WORLDS = {2: 4, 4: 8}  # world size -> K
CAP, C_MAX = 128, 8    # the threaded PQ's per-shard capacity and width
THREADS, OPS = 4, 40   # its client threads and their ops
SPECIAL = [0.0, -0.0, 1e-40, -1e-42, float("inf"), float("-inf"), 1e39,
           3.0]
SCHED = dict(max_batch=4, rounds_cap=2, pq_capacity=64)
SERVE = dict(sessions=2, requests_per_session=3, scheduler="pc-async",
             device="cpu")
DECODE = dict(n_tokens=2, prompt_len=6, max_batch=4)
FAULTS = dict(sessions=4, requests_per_session=8, scheduler="pc",
              device="cpu")


# ---------------------------------------------------------------------------
# Helpers shared by the ranks and the parent
# ---------------------------------------------------------------------------
def _pl(k):
    from repro_torch.core.placement import MeshPlacement
    from repro_torch.launch.mesh import make_combining_mesh

    return MeshPlacement(make_combining_mesh(k, device="cpu"))


def _rows(state):
    return tuple(t.numpy().copy() for t in state)


def _bits(vals):
    return [None if v is None else int(np.float32(v).view(np.uint32))
            for v in vals]


def _stream(seed, n_passes=8, width=10):
    """Seeded published batches of deadlines: ties, ±inf, 1e39,
    subnormals and -0.0 among them."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(n_passes):
        k = int(rng.integers(0, width + 1)) if p else width
        out.append([SPECIAL[int(rng.integers(len(SPECIAL)))]
                    if rng.random() < 0.4 else
                    float(rng.integers(-4, 12)) for _ in range(k)])
    return out


def _replay(records, target):
    """The leader's channel records run on a stacked twin (verdicts are
    the guard's, which the twin does not need)."""
    from repro_torch.core.placement import VERDICT, _led_function

    for name, args, kw in records:
        if name == VERDICT:
            continue
        try:
            _led_function(target, name)(target, *args, **kw)
        except ValueError:
            pass


class _Counted:
    """Patches ``serve``'s executors so each counts the requests it
    executes, and keeps the last workload structure built (its channel
    logging on the leader)."""

    def __init__(self, serve):
        self.n = 0
        self.ds = None
        counted = self

        class Structure(serve.StructureExecutor):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                counted.ds = self.ds
                ch = self.ds.channel
                if ch is not None and ch.is_leader:
                    ch.log = []

            def __call__(self, reqs):
                counted.n += len(reqs)
                return super().__call__(reqs)

        class Decode(serve.DecodeExecutor):
            def __call__(self, reqs):
                counted.n += len(reqs)
                return super().__call__(reqs)

        serve.StructureExecutor = Structure
        serve.DecodeExecutor = Decode


# ---------------------------------------------------------------------------
# The cases (run inside every rank; each returns a small dict)
# ---------------------------------------------------------------------------
def case_pc_pq(world, k):
    """The threaded PQ: the leader's clients and combiner, the followers
    replaying; the leader logs its passes and the channel's records."""
    from repro_torch.core.pc_pq import pc_sharded_priority_queue

    pl = _pl(k)
    init = np.random.default_rng(7).uniform(0, 100, 48).astype(np.float32)
    q = pc_sharded_priority_queue(CAP, C_MAX, n_shards=k, values=init,
                                  placement=pl, device="cpu")
    if not pl.is_leader:
        try:
            q.execute("insert", 1.0)
            named = False
        except RuntimeError as e:
            named = "mesh index 0" in str(e)
        return {"rows": _rows(q.follow().state), "named": named}
    pq = q.pq
    pq.channel.log = []
    passes = []
    real = pq.apply

    def logged(ne, ins):
        out = real(ne, ins)
        passes.append((ne, list(ins), list(out)))
        return out

    pq.apply = logged
    inserted = [[] for _ in range(THREADS)]
    extracted = [[] for _ in range(THREADS)]
    errors = []

    def client(tid):
        try:
            r = np.random.default_rng([world, tid])
            for _ in range(OPS):
                if r.random() < 0.5:
                    v = float(np.float32(r.uniform(0, 100)))
                    q.execute("insert", v)
                    inserted[tid].append(v)
                else:
                    extracted[tid].append(q.execute("extract_min"))
        except BaseException:
            errors.append(traceback.format_exc())

    ts = [threading.Thread(target=client, args=(t,)) for t in range(THREADS)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors[0]
    gathered = _rows(pq.global_state())
    q.close()
    return {"passes": passes, "init": init,
            "records": [(n, a) for n, a, _ in pq.channel.log],
            "inserted": sum(inserted, []), "extracted": sum(extracted, []),
            "rows": _rows(pq.state), "gathered": gathered}


def case_sched_order(world, k):
    """Idle schedulers (the test calls ``_order``) on the leader, one a
    tier, fed one published stream; the followers follow each."""
    from concurrent.futures import Future

    from repro_torch.serving import PCScheduler
    from repro_torch.serving.scheduler import BatchRequest, _Entry

    out = {}
    for tier in ("eliminate", "device"):
        pl = _pl(k)
        sch = PCScheduler(lambda rows: rows, pipeline=False, supervise=False,
                          n_shards=k, tier=tier, pq_placement=pl,
                          device="cpu", **SCHED)
        if not pl.is_leader:
            try:
                sch.submit_async(1, deadline=0.0)
                named = False
            except RuntimeError as e:
                named = "mesh index 0" in str(e)
            sch.follow()
            out[tier] = {"rows": _rows(sch._pq.state), "named": named}
            continue
        passes, epoch = [], 0
        for keys in _stream(3 + world):
            es = [_Entry(BatchRequest(inputs=i, deadline=d), Future(),
                         epoch=epoch + i) for i, d in enumerate(keys)]
            epoch += len(keys)
            passes.append(([[e.epoch for e in b] for b in sch._order(es)],
                           [e.epoch for e in es if e.future.done()]))
        values = [float(v) for v in sch._pq.values()]
        sch.close()
        out[tier] = {"passes": passes, "values": values,
                     "rows": _rows(sch._pq.state)}
    return out


def case_sched_serve(world, k):
    """A threaded scheduler on the leader, 4 submitting threads and a
    combiner kill at pass 2: the supervisor's takeover rebuilds the
    placed deadline PQ, and the followers follow the rebuilt queue."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.serving import PCScheduler

    pl = _pl(k)
    served = []
    sch = PCScheduler(lambda xs: served.extend(xs) or [x * 2 for x in xs],
                      max_batch=4, n_shards=k, pq_placement=pl,
                      fault_plan=FaultPlan(0, kill_combiner_at_pass=2),
                      device="cpu")
    first = sch._pq
    if not pl.is_leader:
        sch.follow()
        return {"rebuilt": sch._pq is not first}
    futs = {}

    def submit(tid):
        for j in range(8):
            i = tid * 8 + j
            futs[i] = sch.submit_async(i, deadline=float(i % 5))

    ts = [threading.Thread(target=submit, args=(t,)) for t in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    got = {i: f.result(timeout=60) for i, f in futs.items()}
    sch.close()
    return {"got": got, "served": served, "takeovers": sch.takeovers,
            "rebuilt": sch._pq is not first}


def case_serve(world, k):
    """run_serving(mesh_shards=K) on every placed workload and decode."""
    from repro_torch.launch import serve

    out = {}
    for w in ("pq", "map", "graph", "decode"):
        c = _Counted(serve)
        kw = dict(SERVE, **(DECODE if w == "decode" else {}))
        stats = serve.run_serving(workload=w, mesh_shards=k, **kw)
        out[w] = {"stats": stats, "executed": c.n}
    return out


def case_serve_faults(world, k):
    """run_serving(mesh_shards=K) under the standard fault plan on every
    placed workload and decode; each rank's rows of the workload
    structure, the leader's records."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.launch import serve

    out = {}
    for w in ("pq", "map", "graph", "decode"):
        c = _Counted(serve)
        kw = dict(FAULTS, **(DECODE if w == "decode" else {}))
        # seed 3: the plan fails the first dispatch it probes (a restore
        # whatever the batching), and kills the combiner at pass 3
        # (blocking submits make at least one pass a request round)
        stats = serve.run_serving(workload=w, mesh_shards=k,
                                  fault_plan=FaultPlan.standard(3), **kw)
        got = {"stats": stats, "executed": c.n}
        if c.ds is not None:
            got["rows"] = _rows(c.ds.state)
            got["records"] = (c.ds.channel.log if c.ds.channel.is_leader
                              else None)
        out[w] = got
    return out


CASES = (("pc-pq", case_pc_pq), ("sched-order", case_sched_order),
         ("sched-serve", case_sched_serve), ("serve", case_serve),
         ("serve-faults", case_serve_faults))


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
        for name, run in CASES:
            try:
                results[name] = ("ok", run(world, WORLDS[world]))
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


def _assemble(res, key="rows"):
    """The ranks' rows, stacked in mesh order: the global (K, ...) leaves."""
    return tuple(np.concatenate([r[key][i] for r in res])
                 for i in range(len(res[0][key])))


def _same_rows(a, b):
    """Bit-equal leaves (dtype, shape and bytes)."""
    a = [np.asarray(x) for x in a]
    b = [np.asarray(y) for y in b]
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b))


@pytest.fixture(scope="module")
def reference_keys():
    """The JAX run_serving's stats keys under ``mesh_shards``."""
    from repro.launch import serve as jserve

    return sorted(jserve.run_serving(workload="pq", sessions=2,
                                     requests_per_session=2, scheduler="pc",
                                     mesh_shards=4))


# ---------------------------------------------------------------------------
# The tests: each reads its case from the world's one job
# ---------------------------------------------------------------------------
def test_pc_pq_leader_passes_replay_bit_equal(job):
    from repro.core import sharded_pq as jspq
    from repro_torch.core import sharded_pq as tspq

    world, k, res = _result(job, "pc-pq")
    lead = res[0]
    passes, init = lead["passes"], lead["init"]
    assert all(r["named"] for r in res[1:])
    assert any(ne for ne, _i, _o in passes) and any(i for _n, i, _o in passes)
    # the channel sent each pass as one record, before it ran
    sent = [tuple(a) for n, a in lead["records"]
            if n == "ShardedBatchedPQ.apply"]
    assert sent == [(ne, ins) for ne, ins, _o in passes]
    tq = tspq.ShardedBatchedPQ(CAP, C_MAX, n_shards=k, values=init,
                               device="cpu")
    jq = jspq.ShardedBatchedPQ(CAP, C_MAX, n_shards=k, values=init,
                               use_pallas=False)
    for i, (ne, ins, out) in enumerate(passes):
        want = _bits(out)
        assert _bits(tq.apply(ne, ins)) == want, f"pass {i}: port stacked"
        assert _bits(jq.apply(ne, ins)) == want, f"pass {i}: JAX"
    stacked = tspq.to_numpy(tq.state)
    assert _same_rows(stacked, (np.asarray(jq.state.a),
                                np.asarray(jq.state.size)))
    assert _same_rows(_assemble(res), stacked)       # every rank's rows
    assert _same_rows(lead["gathered"], stacked)
    a, size = stacked
    left = np.concatenate([a[s, 1:size[s] + 1] for s in range(k)])
    ext = [v for v in lead["extracted"] if v is not None]
    assert sorted(np.concatenate([init, np.float32(lead["inserted"])])
                  .tolist()) == sorted(np.concatenate(
                      [np.float32(ext), left]).tolist())


@pytest.mark.parametrize("tier", ["eliminate", "device"])
def test_scheduler_order_matches_the_reference(job, tier):
    from concurrent.futures import Future

    from repro.serving import scheduler as jsched

    world, k, res = _result(job, "sched-order")
    lead = res[0][tier]
    assert all(r[tier]["named"] for r in res[1:])
    js = jsched.PCScheduler(lambda rows: rows, pipeline=False,
                            supervise=False, n_shards=k, tier=tier, **SCHED)
    try:
        epoch = 0
        for p, keys in enumerate(_stream(3 + world)):
            es = [jsched._Entry(jsched.BatchRequest(inputs=i, deadline=d),
                                Future(), epoch=epoch + i)
                  for i, d in enumerate(keys)]
            epoch += len(keys)
            chosen = [[e.epoch for e in b] for b in js._order(es)]
            failed = [e.epoch for e in es if e.future.done()]
            assert (chosen, failed) == tuple(lead["passes"][p]), \
                f"pass {p}: chosen epochs differ"
        assert lead["values"] == [float(v) for v in js._pq.values()]
        want = (np.asarray(js._pq.state.a), np.asarray(js._pq.state.size))
        assert js.pq_dispatches > 0
    finally:
        js.close()
    assert _same_rows(_assemble([r[tier] for r in res]), want)


def test_threaded_scheduler_follows_a_takeover(job):
    world, k, res = _result(job, "sched-serve")
    lead = res[0]
    assert lead["got"] == {i: 2 * i for i in range(32)}
    assert Counter(lead["served"]) == Counter(range(32))
    assert lead["takeovers"] >= 1
    assert all(r["rebuilt"] for r in res)


@pytest.mark.parametrize("workload", ["pq", "map", "graph", "decode"])
def test_run_serving_on_the_mesh(job, workload, reference_keys):
    world, k, res = _result(job, "serve")
    lead = res[0][workload]
    n = SERVE["sessions"] * SERVE["requests_per_session"]
    assert lead["executed"] == n                     # each request once
    assert all(r[workload]["executed"] == 0 for r in res[1:])
    stats = lead["stats"]
    assert sorted(stats) == reference_keys
    assert stats["placement"] == f"mesh(D={world}, axis='shard')"
    assert stats["mesh_devices"] == world and stats["requests"] == n
    assert all(r[workload]["stats"] == stats for r in res)


@pytest.mark.parametrize("workload", ["pq", "map", "graph", "decode"])
def test_run_serving_standard_faults_on_the_mesh(job, workload):
    """A takeover, a restore (but on decode), every request executed
    once, the same stats on every rank; the ranks' rows of the pq and map workloads are
    a fault-free stacked replay's of the leader's records, and the
    graph's (replicated) state is the leader's on every rank."""
    from repro_torch.core import substrate

    world, k, res = _result(job, "serve-faults")
    res = [r[workload] for r in res]
    lead = res[0]
    n = FAULTS["sessions"] * FAULTS["requests_per_session"]
    assert lead["executed"] == n
    assert all(r["executed"] == 0 for r in res[1:])
    faults = lead["stats"]["faults"]
    assert faults["scheduler_takeovers"] >= 1
    # decode's only placed structure is the deadline PQ, which the
    # elimination pre-pass spares every dispatch here
    assert faults["restores"] > 0 or workload == "decode"
    assert all(r["stats"] == lead["stats"] for r in res)
    if workload in ("pq", "map"):
        spec = substrate.get(workload)
        twin = spec.make(device="cpu",
                         **dict(spec.extras["serve_kw"], n_shards=k))
        _replay(lead["records"], twin)
        assert _same_rows(_assemble(res), twin.state)
    elif workload == "graph":
        assert all(_same_rows(r["rows"], lead["rows"]) for r in res)


# ---------------------------------------------------------------------------
# In this process, D = 1: the leader's pass and its one fetch
# ---------------------------------------------------------------------------
@pytest.fixture
def one_rank_world():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def test_leader_pass_makes_one_fetch_at_one_rank(one_rank_world,
                                                 monkeypatch):
    """At D = 1 the channel runs too: each combining pass sends one
    record and still makes exactly one blocking fetch (DESIGN.md §10)."""
    from repro_torch.core import batched_pq as tbpq
    from repro_torch.core.pc_pq import pc_sharded_priority_queue

    pl = _pl(4)
    assert pl.n_devices == 1 and pl.is_leader
    q = pc_sharded_priority_queue(64, 4, n_shards=4, values=[5.0, 1.0],
                                  placement=pl, device="cpu")
    ch = q.pq.channel
    assert ch is not None and ch.is_leader
    ch.log = []
    real, fetches = tbpq._host_fetch, []
    monkeypatch.setattr(tbpq, "_host_fetch",
                        lambda tree: fetches.append(1) or real(tree))
    got = []
    for v in (7.0, 0.5, 3.0):
        q.execute("insert", v)
        got.append(q.execute("extract_min"))
        assert len(fetches) == 2 * len(got)      # one a pass
    assert got == [1.0, 0.5, 3.0]
    assert [n for n, _a, _k in ch.log] == ["ShardedBatchedPQ.apply"] * 6
    assert len(ch.send_s) == 6
    q.close()
    assert ch.group is None
