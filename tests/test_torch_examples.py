"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``), on the CPU, with the same seeds.

Both sets of examples are loaded by path (``importlib.util``); nothing
under ``examples/`` is a package.  The reference's demos run as they are,
their structures swapped for subclasses that record what they answer.

- ``torch_quickstart`` at ``--rounds 4``: the fused rounds' answers and
  the heap they leave (every shard's array and size) bit-equal to the
  reference's ``ShardedBatchedPQ.apply_rounds`` on the same numpy draws,
  and the demo's printed lines equal; each of the 800 connectivity answers
  equal to the reference ``DynamicGraph``'s for the same pair (a share of
  0.27 at seed 0); the threaded PQ demo conserves the multiset (its values
  follow the threads' order, so no two runs need agree on them).
- ``torch_pq_server`` at ``--sessions 2 --requests 2 --tokens 3
  --max-batch 4``: every request reaches the decode model once under each
  scheduler, and ``serial``'s ``device_steps`` equals the reference
  ``run_serving``'s (a count: exact).
- ``torch_train_lm``: the two ``DEMO_100M`` equal field by field and the
  two parameter counts the same integer (and the same printed line); 2
  steps (batch 2, seq 32) resumed to 4 bit-equal to a straight 4-step
  run, losses and the step-4 checkpoint's every array (the CPU trainer is
  deterministic); a checkpoint the reference's example writes at step 2
  resumed by both trainers for 2 more steps, each loss within
  ``HANDOFF_RTOL`` of the other's.

``HANDOFF_RTOL`` = 1e-3.  Both resume from the same bf16 weights and f32
moments and see the same batches, so the first resumed loss differs only
by the forward's arithmetic: bf16 matmuls summed in other orders
(XLA:CPU against ATen) over 8 layers, 1.6e-5 relative measured (12.3771
against 12.3769); the second also carries one AdamW step whose bf16
rounding of the new weights can fall either side where the two updates
differ in their last bits, 3.1e-5 relative measured.  1e-3 is ~30x
those, and far below what a fault moves: the two resumed losses are 3.5
apart, so a batch or a step off by one, or a leaf restored into the
wrong place, misses by orders more.

The reference's ``train`` runs with a large ``watchdog_factor``: its
straggler retry applies a batch twice (ROADMAP C), which a loaded
machine would otherwise trigger at random.
"""
import contextlib
import dataclasses
import filecmp
import importlib.util
import io
import math
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.train import train as jtrain
from repro.models import transformer as jtransformer
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttransformer

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
HANDOFF_RTOL = 1e-3
SERVE_ARGS = ["--sessions", "2", "--requests", "2", "--tokens", "3",
              "--max-batch", "4"]


def _load(name):
    """``examples/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f"_examples_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _four_threads():
    """Four intra-op threads: the trainer tests run a 94M-parameter model
    beside other test workers.  Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _f32_bits(xs):
    return np.asarray(xs, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
def _reference_quickstart(rounds):
    """The reference's graph and rounds demos, recording: every answered
    ``connected`` pair, and the sharded PQ with its rounds' answers."""
    ref = _load("quickstart")
    seen, pqs = {}, []

    class Graph(ref.DynamicGraph):
        def read_batch(self, methods, inputs):
            got = super().read_batch(methods, inputs)
            for (u, v), a in zip(inputs, got):
                seen[(int(u), int(v))] = bool(a)
            return got

    class PQ(ref.ShardedBatchedPQ):
        def apply_rounds(self, rs):
            self.answers = super().apply_rounds(rs)
            pqs.append(self)
            return self.answers

    ref.DynamicGraph, ref.ShardedBatchedPQ = Graph, PQ
    _, graph_text = _printed(ref.read_dominated_graph)
    _, rounds_text = _printed(ref.fused_rounds, rounds)
    (pq,) = pqs
    return seen, graph_text, pq, rounds_text


def test_quickstart_matches_the_reference():
    twin = _load("torch_quickstart")
    got, text = _printed(twin.main, ["--device", "cpu", "--rounds", "4"])
    seen, graph_text, jpq, rounds_text = _reference_quickstart(4)

    # the fused rounds: answers and every shard bit-equal, lines equal
    r = got["rounds"]
    assert len(r["answers"]) == 4
    for a, b in zip(r["answers"], jpq.answers):
        np.testing.assert_array_equal(_f32_bits(a), _f32_bits(b))
    ja, jsize = jax.device_get((jpq.state.a, jpq.state.size))
    np.testing.assert_array_equal(r["heap"].view(np.uint32),
                                  np.asarray(ja).view(np.uint32))
    np.testing.assert_array_equal(r["sizes"], np.asarray(jsize))
    assert rounds_text in text

    # the graph: every one of the 800 answers equal to the reference's
    g = got["graph"]
    assert len(g["answers"]) == len(g["queries"]) == 800
    assert all(q in seen for q in g["queries"])
    assert [seen[q] for q in g["queries"]] == g["answers"]
    assert f"{sum(g['answers']) / 800:.2f}" == "0.27"
    assert graph_text.splitlines()[-1] in text

    # the threaded PQ: the multiset conserved
    p = got["pq"]
    assert len(p["inserted"]) == 100
    assert sorted(p["extracted"] + p["remaining"]) == \
        sorted(p["initial"] + p["inserted"])
    assert "conservation True" in text


# ---------------------------------------------------------------------------
# pq_server
# ---------------------------------------------------------------------------
def test_pq_server_serves_each_request_once(monkeypatch):
    twin = _load("torch_pq_server")
    served = []
    init, call = tserve.DecodeExecutor.__init__, tserve.DecodeExecutor.__call__

    def tagged(self, *args, **kw):
        """An executor a row, in the order the rows run."""
        init(self, *args, **kw)
        self.row = len(served)
        served.append([])

    def spy(self, reqs):
        served[self.row].append([id(r) for r in reqs])
        return call(self, reqs)

    monkeypatch.setattr(tserve.DecodeExecutor, "__init__", tagged)
    monkeypatch.setattr(tserve.DecodeExecutor, "__call__", spy)
    rows = twin.main(SERVE_ARGS + ["--device", "cpu"])
    assert list(rows) == list(twin.SCHEDULERS) and len(served) == 3
    for sched, batches in zip(twin.SCHEDULERS, served):
        ids = [i for b in batches for i in b]
        assert len(ids) == len(set(ids)) == 4, (sched, batches)
        assert rows[sched]["requests"] == 4
        assert all(len(b) <= 4 for b in batches)
    want = jserve.run_serving("qwen2_0_5b", sessions=2,
                              requests_per_session=2, n_tokens=3,
                              max_batch=4, scheduler="serial", seed=0)
    assert rows["serial"]["device_steps"] == want["device_steps"] > 0
    for sched in ("pc", "pc-async"):
        assert rows[sched]["device_steps"] <= rows["serial"]["device_steps"]


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------
@pytest.fixture
def _registered():
    """The demo config registered by each example is taken out again."""
    yield
    for name in ("repro.configs.demo_100m", "repro_torch.configs.demo_100m"):
        sys.modules.pop(name, None)


def test_demo_config_and_parameter_count_equal_the_reference(_registered):
    twin, ref = _load("torch_train_lm"), _load("train_lm")
    assert dataclasses.asdict(twin.DEMO_100M) == \
        dataclasses.asdict(ref.DEMO_100M)
    shapes = jax.eval_shape(
        lambda: jtransformer.model_init(jax.random.PRNGKey(0),
                                        ref.DEMO_100M)[0])
    want = jtransformer.count_params(shapes)
    assert twin.param_count() == want
    drawn = ttransformer.model_init(0, twin.DEMO_100M, device="cpu")
    assert ttransformer.count_params(drawn) == want
    assert 90e6 < want < 110e6
    twin.register()
    from repro_torch import configs
    assert configs.get("demo_100m") is twin.DEMO_100M


def _twin_train(twin, ckpt, steps):
    return _printed(twin.main, [
        "--steps", str(steps), "--batch", "2", "--seq", "32",
        "--ckpt-dir", str(ckpt), "--device", "cpu"])


def test_train_lm_resume_is_bit_equal_to_a_straight_run(tmp_path,
                                                        _registered):
    twin = _load("torch_train_lm")
    first, _ = _twin_train(twin, tmp_path / "a", 2)
    resumed, text = _twin_train(twin, tmp_path / "a", 4)
    straight, _ = _twin_train(twin, tmp_path / "b", 4)
    assert "[train] resumed from step 2" in text
    assert len(resumed["losses"]) == 2
    np.testing.assert_array_equal(
        _f32_bits(first["losses"] + resumed["losses"]),
        _f32_bits(straight["losses"]))
    assert resumed["final_loss"] < straight["first_loss"]
    a, b = (tmp_path / d / "step_0000000004" for d in ("a", "b"))
    names = sorted(p.name for p in a.glob("*.npy"))
    assert names == sorted(p.name for p in b.glob("*.npy"))
    assert len(names) > 10
    assert all(filecmp.cmp(a / n, b / n, shallow=False) for n in names)


def test_train_lm_resumes_the_references_checkpoint(tmp_path, monkeypatch,
                                                    _registered):
    """The reference's example writes step 2; the reference's trainer and
    the port's each resume it for 2 more steps (HANDOFF_RTOL)."""
    ref, twin = _load("train_lm"), _load("torch_train_lm")
    runs = []

    def train(*args, **kw):
        runs.append(jtrain(*args, watchdog_factor=1e9, **kw))
        return runs[-1]

    def ref_main(steps, ckpt):
        monkeypatch.setattr(sys, "argv", [
            "train_lm.py", "--steps", str(steps), "--batch", "2", "--seq",
            "32", "--ckpt-dir", str(ckpt)])
        return _printed(ref.main)[1]

    monkeypatch.setattr(ref, "train", train)
    ref_text = ref_main(2, tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref_text += ref_main(4, tmp_path / "ref")
    got, text = _twin_train(twin, tmp_path / "port", 4)

    count = [x for x in ref_text.splitlines() if "M params" in x][0]
    assert count in text
    assert "[train] resumed from step 2" in ref_text
    assert "[train] resumed from step 2" in text
    want = (runs[1]["first_loss"], runs[1]["final_loss"])
    assert len(got["losses"]) == 2
    for g, w in zip(got["losses"], want):
        assert math.isclose(g, w, rel_tol=HANDOFF_RTOL), (got["losses"],
                                                          want)
