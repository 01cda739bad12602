"""The port's serving entry point (``repro_torch.launch.serve``) on the CPU.

- ``StructureExecutor``: for every registered workload, both packages'
  ``_structure_requests`` draw equal request tables from one seed; the
  table, cut into the same batches, goes through both packages'
  executors with ``megapass`` off and on; every answer is held by the
  spec's ``result_ok`` and the final state by its ``dump_compare``
  against the reference's own host mirror of its state.
- Decode serving: a reduced Qwen2 with the JAX weights carried across
  (``models/convert.py``) and an f32 cache; the port's ``PCScheduler`` over
  ``DecodeExecutor`` and ``SerialScheduler`` over the same executor give
  the same tokens for every request, and each batch the PC executor saw
  gives the same tokens through the JAX ``DecodeExecutor`` (its bf16
  cache patched to f32, as ``tests/test_torch_models.py`` does).
- ``run_serving`` for every workload x scheduler: the reference's stats
  keys, ``device_steps`` of the PC schedulers ≤ serial's; the CLI, the
  fault plan built from its flags, ``--mesh-shards`` on a one-rank mesh
  (the placed workloads and decode served, under faults too, the other
  structures refused), and the refusal of a device without CUDA.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import substrate as jsub
from repro.core.faults import FaultPlan as JFaultPlan
from repro.launch import serve as jserve
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.core import substrate as tsub
from repro_torch.core.faults import FaultPlan
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.serving import PCScheduler, SerialScheduler

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
WORKLOADS = ("graph", "map", "pq", "sketch", "unionfind")
SCHEDULERS = ("serial", "pc", "pc-async", "pc-nodonate", "pc-pallas")
WAIT = 60


def _serve_kw(spec, n_vertices=64):
    """``run_serving``'s sizing rule."""
    kw = dict(spec.extras.get("serve_kw", {}))
    if spec.name == "graph":
        kw["n"] = n_vertices
        kw.setdefault("edge_capacity", 16 * n_vertices)
    return kw


def test_registry_serve_kw_matches_the_reference():
    assert tsub.get("pq").extras["serve_kw"] == dict(capacity=4096,
                                                     c_max=16, n_shards=4)
    assert tsub.names() == jsub.names() == sorted(WORKLOADS)
    for name in WORKLOADS:
        assert (tsub.get(name).extras["serve_kw"]
                == jsub.get(name).extras["serve_kw"]), name
    # the placement marker sits on the structures whose constructor takes
    # placement= (DESIGN.md §18), as in the reference
    for name in WORKLOADS:
        marked = bool(tsub.get(name).extras.get("placement"))
        assert marked == bool(jsub.get(name).extras.get("placement")), name
        assert marked == (name in ("graph", "map", "pq")), name


# ---------------------------------------------------------------------------
# StructureExecutor against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("megapass", [False, True],
                         ids=["alternating", "megapass"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_structure_executor_matches_the_reference(name, megapass):
    tspec, jspec = tsub.get(name), jsub.get(name)
    kw = _serve_kw(tspec)
    assert kw == _serve_kw(jspec)
    ttab = serve._structure_requests(tspec, np.random.default_rng(5), 4, 6,
                                     40, kw)
    jtab = jserve._structure_requests(jspec, np.random.default_rng(5), 4, 6,
                                      40, kw)
    assert ttab == jtab
    reqs = [r for row in ttab for r in row]
    tex = serve.StructureExecutor(tspec, megapass=megapass, device="cpu",
                                  **kw)
    jex = jserve.StructureExecutor(jspec, megapass=megapass, **kw)
    assert tex.megapass == megapass
    for i in range(0, len(reqs), 8):
        batch = reqs[i:i + 8]
        got, want = tex(batch), jex(batch)
        assert len(got) == len(want) == len(batch)
        for r, g, w in zip(batch, got, want):
            assert tspec.result_ok(r["method"], g, w), (r, g, w)
    tspec.dump_compare(tex.ds, jspec.make_host(jex.ds))
    assert tex.device_steps == jex.device_steps
    assert tex.megapass_rounds == jex.megapass_rounds


# ---------------------------------------------------------------------------
# decode serving: PC == serial == the JAX executor, batch by batch
# ---------------------------------------------------------------------------
def test_decode_serving_tokens_match_serial_and_jax(monkeypatch):
    jc = jconfigs.get_reduced("qwen2_0_5b")
    tc = tconfigs.get_reduced("qwen2_0_5b")
    jparams, _ = jt.model_init(jax.random.PRNGKey(0), jc)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tc, device=CPU)
    prompt, new, sessions, per = 8, 3, 3, 3
    ex = serve.DecodeExecutor(tc, max_batch=4, max_len=prompt + new + 1,
                              params=tparams, device=CPU,
                              cache_dtype=torch.float32)
    seen = []

    def step(reqs):
        seen.append(list(reqs))
        return ex(reqs)

    rng = np.random.default_rng(3)
    reqs = [{"prompt": rng.integers(2, tc.vocab, prompt).astype(np.int32),
             "n_tokens": new} for _ in range(sessions * per)]
    pc_out = [None] * len(reqs)

    with PCScheduler(step, max_batch=4, device="cpu") as sch:
        def session(s):
            futs = [(j, sch.submit_async(reqs[j], deadline=float(j)))
                    for j in range(s * per, (s + 1) * per)]
            for j, f in futs:
                pc_out[j] = f.result(timeout=WAIT)

        ts = [threading.Thread(target=session, args=(s,))
              for s in range(sessions)]
        [t.start() for t in ts]
        [t.join() for t in ts]
    assert all(o is not None for o in pc_out)
    assert sum(len(b) for b in seen) == len(reqs)
    assert all(len(b) <= 4 for b in seen)

    serial = SerialScheduler(ex)
    for j, r in enumerate(reqs):
        assert serial.submit(r).tolist() == pc_out[j].tolist(), j

    make_cache = jt.init_cache
    monkeypatch.setattr(jserve.transformer, "init_cache",
                        lambda *a: jax.tree.map(
                            lambda x: x.astype(jnp.float32), make_cache(*a)))
    jex = jserve.DecodeExecutor(jc, max_batch=4, max_len=prompt + new + 1)
    jex.params = jparams
    index = {id(r): j for j, r in enumerate(reqs)}
    for batch in seen:
        for r, w in zip(batch, jex(batch)):
            assert pc_out[index[id(r)]].tolist() == w.tolist()


# ---------------------------------------------------------------------------
# run_serving and the CLI
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_keys():
    """The reference's stats keys, plain and with megapass + faults (the
    keys do not depend on the workload)."""
    plain = jserve.run_serving(workload="unionfind", sessions=2,
                               requests_per_session=2, scheduler="pc")
    extra = jserve.run_serving(workload="unionfind", sessions=2,
                               requests_per_session=2, scheduler="pc",
                               megapass=True, fault_plan=JFaultPlan(0))
    return sorted(plain), sorted(extra)


@pytest.mark.parametrize("workload", ("decode",) + WORKLOADS)
def test_run_serving_every_scheduler(workload, reference_keys):
    plain_keys, _ = reference_keys
    kw = dict(workload=workload, sessions=3, requests_per_session=3,
              n_tokens=2, prompt_len=6, max_batch=4, device="cpu")
    steps = {}
    for sch in SCHEDULERS:
        stats = serve.run_serving(scheduler=sch, **kw)
        assert sorted(stats) == plain_keys, sch
        assert stats["requests"] == 9 and stats["scheduler"] == sch
        steps[sch] = stats["device_steps"]
        if sch != "serial":
            assert sum(stats["tier_decisions"].values()) >= 1
    assert all(steps[s] <= steps["serial"] for s in SCHEDULERS), steps


def test_run_serving_megapass_and_faults(reference_keys):
    _, extra_keys = reference_keys
    stats = serve.run_serving(workload="unionfind", sessions=2,
                              requests_per_session=2, scheduler="pc",
                              megapass=True, fault_plan=FaultPlan(0),
                              device="cpu")
    assert sorted(stats) == extra_keys


def test_cli_standard_faults_take_over_and_serve_everything(capsys):
    stats = serve.main(["--device", "cpu", "--workload", "pq",
                        "--scheduler", "pc-async", "--faults", "standard",
                        "--requests", "16"])
    assert stats["requests"] == 128
    assert stats["faults"]["scheduler_takeovers"] >= 1
    assert stats["faults"]["combiner_kills"] == 1
    assert "[serve]" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    [], ["--faults", "standard", "--fault-seed", "3"],
    ["--fault-kill-pass", "2"],
    ["--fault-dispatch-rate", "0.2", "--fault-latency-spike", "4",
     "--fault-latency-spike", "7", "--fault-latency-spike-s", "0.01"],
])
def test_build_fault_plan_matches_the_reference(argv):
    args = serve.build_parser().parse_args(argv)
    got, want = serve.build_fault_plan(args), jserve.build_fault_plan(args)
    assert (got is None) == (want is None)
    if got is not None:
        fields = ("seed", "kill_combiner_at_pass", "dispatch_fail_rate",
                  "max_dispatch_failures", "latency_spike_passes",
                  "latency_spike_s", "drop_record_rate")
        assert ({f: getattr(got, f) for f in fields}
                == {f: getattr(want, f) for f in fields})


@pytest.fixture
def one_rank_world():
    """The one-rank process group ``make_combining_mesh`` starts, torn
    down after the test so no group outlives it in the worker."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_shards_wait_for_the_placement_layer(one_rank_world):
    """``--mesh-shards 4`` on a one-process world (D = 1): the placed
    workloads serve every request with the reference's stats keys and
    layout name; ``decode`` places its deadline PQ alone, as the
    reference does; a structure without the placement marker is
    refused; under the standard fault plan the combiner's takeover
    rebuilds the placed deadline PQ and every request is still served."""
    want = jserve.run_serving(workload="pq", sessions=2,
                              requests_per_session=2, scheduler="pc",
                              mesh_shards=4)
    for name in ("pq", "map", "graph"):
        stats = serve.run_serving(workload=name, sessions=2,
                                  requests_per_session=3, mesh_shards=4,
                                  scheduler="pc-async", device="cpu")
        assert sorted(stats) == sorted(want), name
        assert stats["placement"] == want["placement"] \
            == "mesh(D=1, axis='shard')"
        assert stats["requests"] == 6 and stats["mesh_devices"] == 1
    stats = serve.main(["--device", "cpu", "--workload", "pq",
                        "--mesh-shards", "4"])
    assert stats["placement"] == "mesh(D=1, axis='shard')"
    stats = serve.run_serving(workload="decode", sessions=2,
                              requests_per_session=2, n_tokens=2,
                              prompt_len=6, max_batch=4, mesh_shards=4,
                              device="cpu")
    assert stats["placement"] == "mesh(D=1, axis='shard')"
    assert stats["requests"] == 4 and stats["mesh_devices"] == 1
    stats = serve.main(["--device", "cpu", "--workload", "pq",
                        "--scheduler", "pc-async", "--faults", "standard",
                        "--requests", "16", "--mesh-shards", "4"])
    assert stats["requests"] == 128
    assert stats["faults"]["scheduler_takeovers"] >= 1
    for name in ("unionfind", "sketch"):
        with pytest.raises(ValueError, match="mesh-shards"):
            serve.run_serving(workload=name, mesh_shards=4, device="cpu")
    with pytest.raises(ValueError, match="mesh-shards"):
        serve.run_serving(workload="pq", mesh_shards=0, device="cpu")


def test_serving_entry_points_refuse_to_run_without_cuda():
    code = """
import pytest
from repro_torch.core import substrate
from repro_torch.launch import serve
from repro_torch.serving import PCScheduler
for make in (lambda: PCScheduler(lambda rows: rows),
             lambda: serve.StructureExecutor(substrate.get("pq")),
             lambda: serve.run_serving(workload="pq"),
             lambda: serve.run_serving(workload="decode"),
             lambda: serve.main(["--workload", "graph"])):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
print("refused")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0 and "refused" in r.stdout, r.stdout + r.stderr
