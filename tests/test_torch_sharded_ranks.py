"""The port's sharded training (``launch/steps.py`` and
``launch/train.py`` on a mesh) across spawned gloo ranks, against the
JAX package's unsharded train step and the port's own.

One spawned job a world (``torch.multiprocessing``, the spawn start
method, a ``FileStore`` under ``tmp_path``, one thread a rank) runs every
case on every rank, SPMD:

- four ranks, the reduced configs at f32 with the reference's
  ``model_init`` weights (``tests/test_torch_train.py``'s ``_params``) and
  the pipeline's batches (4 × 32): ``qwen2_0_5b``, ``rwkv6_3b`` and
  ``recurrentgemma_2b`` on 4 × 1 (``pure_dp``: the batch over data ×
  model, FSDP on data), ``yi_6b`` on 2 × 2 (FSDP on data, TP on model,
  with the full config's ``seq_shard``: the residual stream's sequence
  over model),
  ``rwkv6_3b`` with ``pure_dp=False`` on 2 × 2 (the scan on a shard of
  the heads) and ``rwkv6_3b`` on the pod mesh 2 × 1 × 2 with
  ``grad_compress`` (the int8 round trip on the reduced gradient): two
  AdamW steps through ``make_train_step(cfg, mesh)``, beside the port's
  unsharded step on the same weights, every leaf gathered after each;
- the logits' rows: a sharded step of ``qwen2_0_5b`` (vocab 8,192) on
  4 × 1 holds no
  local logits tensor of more rows than its rank's batch shard;
- serving: the reduced ``qwen2_0_5b`` and ``yi_6b`` prefilled and
  decoded through the mesh steps on 2 × 2 in the serving layout (TP, the
  caches' sequence sharded), beside the unsharded steps;
- an async save on 2 × 1: the checkpoint is saved with
  ``blocking=False`` and written only after the next in-place AdamW
  step, and restores the state at the save, bit for bit;
- the elastic restart: ``train()`` of the reduced ``qwen2_0_5b`` (bf16,
  the trainer's weights) for 2 steps on 4 ranks (2 × 2) with a
  checkpoint, then resumed on 2 ranks (2 × 1) for 2 more.

The parent computes the reference's results (the JAX package's jitted
``make_train_step``; for the pod case ``jax.value_and_grad`` of its loss,
its int8 quantizer's round trip, its AdamW) while the ranks run, and one
process's 4-step ``train()``.  The ranks import no JAX.

Tolerances, each with its reason:

- against the reference, ``tests/test_torch_train.py``'s: the loss within
  rtol 1e-5, the global norm within rtol 1e-3, the parameters after two
  steps within rtol 1e-5 plus lr absolute;
- against the port's unsharded step, tighter: a sharded step sums the
  same terms in another order (the batch shards' partial gradients, TP's
  partial products) and is otherwise the same arithmetic.  The loss
  within rtol 1e-6 (worst reading 1.8e-7), the global norm within rtol
  1e-5 (4.8e-6, ``rwkv6_3b-tp``), the moments after the first step (m and
  v are the gradients and their squares, scaled) within 2e-5 of each
  leaf's largest (1.0e-5, ``rwkv6_3b-tp``: its scan's head shards sum in
  another order; 1.7e-6 elsewhere).  The parameters: every element
  within rtol 1e-5 plus lr absolute, and at most one element in 4,000
  beyond rtol 1e-5 plus 1e-6 absolute (worst 13 of 112,192,
  ``rwkv6_3b-tp``; 6 in the pod case, 4 or fewer elsewhere).  AdamW's
  update lr·m/(√v + 1e-8) amplifies the reordering where a gradient is a
  cancellation within ~1e-8 of 0, and in the pod case where a gradient
  element sits on a rounding boundary of its int8 code;
- the elastic restart's four losses within rtol 1e-3 of the
  uninterrupted run's: the trainer's weights are bf16, and a reordered
  sum that flips one weight's last bit moves the loss by ~1e-4.

Every job has its own limit: a gloo timeout at init, and a join with a
deadline that kills the ranks and fails the test.
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
LR = 1e-3
B, S = 4, 32
# name -> (arch, model_parallel, pods, config overrides)
CONFIGS = {
    "qwen2_0_5b": ("qwen2_0_5b", 1, 1, {}),
    "rwkv6_3b": ("rwkv6_3b", 1, 1, {}),
    "recurrentgemma_2b": ("recurrentgemma_2b", 1, 1, {}),
    "yi_6b": ("yi_6b", 2, 1, {"seq_shard": True}),
    "rwkv6_3b-tp": ("rwkv6_3b", 2, 1, {"pure_dp": False}),
    "rwkv6_3b-pod": ("rwkv6_3b", 2, 2, {}),
}
SERVE = ("qwen2_0_5b", "yi_6b")
ELASTIC = dict(arch_id="qwen2_0_5b", batch=4, seq=32, lr=LR, ckpt_every=100,
               log_every=100, device="cpu")


# ---------------------------------------------------------------------------
# The cases (run inside every rank)
# ---------------------------------------------------------------------------
def _numpy(tree):
    from repro_torch.optim.tree import leaves

    return [t.detach().numpy().copy() for t in leaves(tree)]


def case_train(name, init, batches):
    """Two sharded steps beside two unsharded ones on the same weights:
    (sharded metrics, unsharded metrics, sharded and unsharded parameter
    leaves, sharded and unsharded moment leaves), a step each."""
    from repro_torch import configs
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for_world
    from repro_torch.models import convert
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.compress import (compress_grads_int8,
                                            decompress_grads_int8)
    from repro_torch.optim.tree import leaves

    arch, mp, pods, kw = CONFIGS[name]
    world = torch.distributed.get_world_size()
    mesh = make_mesh_for_world(world, model_parallel=mp, pods=pods,
                               device="cpu")
    cfg = configs.get_reduced(arch).with_(**kw)
    pu = convert.params_from_numpy(init, cfg, device="cpu")
    pd = sh.distribute_tree(convert.params_from_numpy(init, cfg,
                                                      device="cpu"),
                            sh.param_specs(cfg, mesh, "train"), mesh)
    ou, od = adamw_init(pu), adamw_init(pd)
    compress = pods > 1
    unsharded = steps.make_train_step(cfg, lr=LR)
    sharded = steps.make_train_step(cfg, mesh, lr=LR, grad_compress=compress)
    out = []
    for hb in batches:
        b = {k: torch.from_numpy(v) for k, v in hb.items()}
        if compress:                   # the unsharded twin of the round trip
            lu, g = steps.loss_and_grads(pu, cfg, b)
            q, s, _ = compress_grads_int8(g)
            pu, ou, gn = adamw_update(pu, decompress_grads_int8(q, s), ou,
                                      lr=LR)
            mu = {"loss": lu, "gnorm": gn}
        else:
            pu, ou, mu = unsharded(pu, ou, dict(b))
        pd, od, md = sharded(pd, od, dict(b))
        out.append(((float(md["loss"]), float(md["gnorm"])),
                    (float(mu["loss"]), float(mu["gnorm"])),
                    _numpy(sh.gather_tree(pd)), _numpy(pu),
                    _numpy(sh.gather_tree((od.m, od.v))),
                    _numpy((ou.m, ou.v))))
    for t in leaves(pd):               # every leaf stayed a DTensor shard
        assert type(t).__name__ == "DTensor"
    return out


def case_logit_rows(batches):
    """One sharded train step of ``qwen2_0_5b`` with a vocab of 8,192 (so
    the tied table outweighs a loss chunk's activations, as at full
    width) on 4 × 1 (FSDP on data: the table's d dim sharded) under a
    dispatch mode that sees the local ops: the most batch rows any local
    logits tensor holds, forward and backward, and the rows of this
    rank's batch shard."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch import configs
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for_world
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init

    mesh = make_mesh_for_world(4, device="cpu")
    cfg = configs.get_reduced("qwen2_0_5b").with_(vocab=8192)
    p = sh.distribute_tree(transformer.model_init(0, cfg, device="cpu"),
                           sh.param_specs(cfg, mesh, "train"), mesh)
    b = {k: torch.from_numpy(v) for k, v in batches[0].items()}

    class Rows(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):   # (DTensor's sharding propagation
                # runs ops on fake tensors of the global shapes)
                if isinstance(t, torch.Tensor) and t.dim() == 3 \
                        and t.shape[-1] == cfg.vocab \
                        and not isinstance(t, FakeTensor):
                    self.most = max(self.most, t.shape[0])
            return out

    step = steps.make_train_step(cfg, mesh, lr=LR)
    with Rows() as rows:
        step(p, adamw_init(p), b)
    return rows.most, B // 4


def case_serve(arch):
    """A prefill of 4 x 12 and 4 decode steps through the mesh steps on
    2 x 2 in the serving layout (TP on model; the reduced configs' single
    KV head shards the caches' sequence) beside the unsharded steps, at
    f32: (greedy tokens equal, worst logit and cache differences)."""
    from repro_torch import configs
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for_world
    from repro_torch.models import transformer
    from repro_torch.models.layers import map_specs
    from repro_torch.optim.tree import leaves, tree_map

    B, P, N = 4, 12, 4
    mesh = make_mesh_for_world(4, model_parallel=2, device="cpu")
    cfg = configs.get_reduced(arch).with_(pure_dp=False,
                                          decode_cache_len=P + N)
    params = tree_map(lambda t: t.float(),
                      transformer.model_init(0, cfg, device="cpu"))
    shapes = sh.cache_shapes(cfg, B, P + N)
    specs = []
    map_specs(lambda x: specs.append(tuple(x)) or x,
              sh.cache_specs(cfg, mesh, shapes))
    assert any(len(x) == 5 and x[2] == "model" for x in specs), \
        "no cache shards its sequence"
    toks = torch.randint(0, cfg.vocab, (B, P),
                         generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32)
    got = {}
    for m in (None, mesh):
        p = params if m is None else sh.distribute_tree(
            params, sh.param_specs(cfg, m, "serve"), m)
        cache = transformer.init_cache(cfg, B, P + N, device="cpu",
                                       dtype=torch.float32)
        if m is not None:
            cache = sh.distribute_tree(cache, sh.cache_specs(cfg, m, shapes),
                                       m)
        last, cache = steps.make_prefill_step(cfg, m)(p, {"tokens": toks},
                                                      cache)
        last = sh.gather_tree(last)
        nxt = torch.argmax(last, -1).to(torch.int32)
        out = [nxt]
        for i in range(N):
            nxt, cache = steps.make_decode_step(cfg, m)(
                p, cache, P + i, {"tokens": nxt[:, None]})
            nxt = sh.gather_tree(nxt)
            out.append(nxt)
        got[m is None] = (last, torch.stack(out, 1),
                          [t.clone() for t in leaves(sh.gather_tree(cache))])
    (lu, tu, cu), (ld, td, cd) = got[True], got[False]
    return (bool(torch.equal(tu, td)),
            float((lu - ld).abs().max() / lu.abs().max()),
            max(float((a - b).abs().max()) for a, b in zip(cu, cd)))


def case_elastic(ckpt, steps):
    """``train()`` on this world's mesh, from the newest checkpoint in
    ``ckpt``; returns its losses, its world and the mesh it built."""
    from repro_torch.launch.train import train

    world = torch.distributed.get_world_size()
    m = train(steps=steps, ckpt_dir=ckpt, model_parallel=world // 2,
              **ELASTIC)
    return m["losses"], m["world"]


def case_async_save(save_dir, init, batches):
    """On 2 x 1 (FSDP on data; the norms' gains replicated, so their full
    arrays are views of the live shards): a sharded step, an async save,
    and the next in-place step run while the save is still unwritten (the
    writer thread waits for it); the checkpoint, restored onto the mesh,
    holds the state at the save.  Returns (leaves, leaves equal to the
    state at the save, leaves equal to the state after the next step)."""
    import threading

    from repro_torch import configs
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for_world
    from repro_torch.models import convert
    from repro_torch.optim import adamw_init
    from repro_torch.optim.tree import leaves

    mesh = make_mesh_for_world(2, device="cpu")
    cfg = configs.get_reduced("qwen2_0_5b")
    p = sh.distribute_tree(convert.params_from_numpy(init, cfg, device="cpu"),
                           sh.param_specs(cfg, mesh, "train"), mesh)
    o = adamw_init(p)
    step = steps.make_train_step(cfg, mesh, lr=LR)
    b1, b2 = ({k: torch.from_numpy(v) for k, v in hb.items()}
              for hb in batches)

    def snapshot(tree):
        return [t.detach().numpy().copy()
                for t in leaves(sh.gather_tree(tree))]

    p, o, _ = step(p, o, b1)
    at_save = snapshot({"params": p, "opt": o})
    stepped, write = threading.Event(), ck._write

    def held(*args, **kwargs):
        assert stepped.wait(GLOO_S), "the next step never ran"
        return write(*args, **kwargs)

    ck._write = held
    try:
        mgr = ck.CheckpointManager(save_dir)
        mgr.save(1, {"params": p, "opt": o}, blocking=False)
        p, o, _ = step(p, o, b2)
        stepped.set()
        mgr.wait()
    finally:
        ck._write = write
    after = snapshot({"params": p, "opt": o})
    torch.distributed.barrier()            # rank 0 has written
    got, tree, _ = mgr.restore_latest({"params": p, "opt": o})
    assert got == 1
    restored = snapshot(tree)
    return (len(restored),
            sum(np.array_equal(r, a) for r, a in zip(restored, at_save)),
            sum(np.array_equal(r, a) for r, a in zip(restored, after)))


def _cases(world, payload):
    if world == 4:
        out = [(n, lambda n=n: case_train(n, payload["init"][n],
                                           payload["batches"][n]))
               for n in CONFIGS]
        out.append(("logit-rows", lambda: case_logit_rows(
            payload["batches"]["qwen2_0_5b"])))
        out += [(f"serve-{a}", lambda a=a: case_serve(a)) for a in SERVE]
        out.append(("elastic", lambda: case_elastic(payload["ckpt"], 2)))
        return out
    return [("async-save", lambda: case_async_save(payload["save"],
                                                   payload["init"],
                                                   payload["batches"])),
            ("elastic", lambda: case_elastic(payload["ckpt"], 4))]


# ---------------------------------------------------------------------------
# The spawned jobs
# ---------------------------------------------------------------------------
def _rank_main(rank, world, store, payload, q):
    import logging
    import warnings

    import torch.distributed as dist

    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    torch.set_num_threads(1)
    results = {}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=GLOO_S))
        for name, run in _cases(world, payload):
            try:
                val = run()
                # the gathered leaves are equal on every rank: rank 0 sends
                results[name] = ("ok", val if rank == 0 or name in
                                 ("elastic", "async-save") else None)
            except Exception:
                results[name] = ("error", traceback.format_exc())
                break          # the ranks are out of step from here on
    except Exception:
        results["init"] = ("error", traceback.format_exc())
    finally:
        q.put((rank, results))
        if dist.is_initialized():
            dist.destroy_process_group()


class _Job:
    def __init__(self, world, tmp, payload):
        ctx = torch.multiprocessing.get_context("spawn")
        self.world, self.q = world, ctx.Queue()
        store = os.path.join(tmp, f"store{world}")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, store, payload, self.q),
                                  daemon=True) for r in range(world)]
        self.t0 = time.monotonic()
        self.deadline = self.t0 + JOB_S
        for p in self.procs:
            p.start()

    def join(self):
        got = {}
        try:
            while len(got) < self.world:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, res = self.q.get(timeout=min(left, 5.0))
                except queue.Empty:
                    if not any(p.is_alive() for p in self.procs) \
                            and self.q.empty():
                        break
                    continue
                got[rank] = res
        finally:
            for p in self.procs:
                p.join(max(0.0, min(10.0, self.deadline - time.monotonic())))
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        return got, time.monotonic() - self.t0


def _reference(name, init, batches):
    """The JAX package's two unsharded steps: (loss, gnorm) a step and
    the leaves after the last."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models import lm as jlm
    from repro.optim import adamw_init as jadamw_init
    from repro.optim import adamw_update as jadamw_update
    from repro.optim.compress import (compress_grads_int8,
                                      decompress_grads_int8)

    arch, _, pods, kw = CONFIGS[name]
    jc = jconfigs.get_reduced(arch).with_(**kw)
    if pods > 1:
        def step(p, o, b):
            loss, g = jax.value_and_grad(lambda q: jlm.loss_fn(q, jc, b))(p)
            q, s, _ = compress_grads_int8(g)
            p, o, gn = jadamw_update(p, decompress_grads_int8(q, s), o,
                                     lr=LR)
            return p, o, {"loss": loss, "gnorm": gn}
        step = jax.jit(step)
    else:
        step = jax.jit(jmake_train_step(jc, lr=LR))
    p = jax.tree.map(jnp.asarray, init)
    o = jadamw_init(p)
    metrics = []
    for hb in batches:
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in hb.items()})
        metrics.append((float(m["loss"]), float(m["gnorm"])))
    return metrics, [np.asarray(x) for x in jax.tree.leaves(p)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from test_torch_train import _batches, _params

    tmp = str(tmp_path_factory.mktemp("sharded"))
    init, batches = {}, {}
    for name, (arch, _, _, _) in CONFIGS.items():
        jp, _ = _params(arch)
        init[name] = jax.tree.map(np.asarray, jp)
        batches[name] = _batches(arch, 2, batch=B, seq=S)
    ckpt = os.path.join(tmp, "ckpt")
    job = _Job(4, tmp, {"init": init, "batches": batches, "ckpt": ckpt})
    ref = {n: _reference(n, init[n], batches[n]) for n in CONFIGS}
    got4 = job.join()
    got2 = _Job(2, tmp, {"ckpt": ckpt, "save": os.path.join(tmp, "async"),
                         "init": init["qwen2_0_5b"],
                         "batches": batches["qwen2_0_5b"]}).join()
    from repro_torch.launch.train import train
    whole = train(steps=4, ckpt_dir=os.path.join(tmp, "whole"), **ELASTIC)
    return {"ref": ref, 4: got4, 2: got2, "whole": whole, "ckpt": ckpt}


def _result(runs, world, case):
    got, seconds = runs[world]
    assert seconds < JOB_S + 30, f"job ran {seconds:.0f} s"
    missing = [r for r in range(world) if r not in got]
    assert not missing, f"ranks {missing} sent nothing before the deadline"
    out = []
    for r in range(world):
        status, val = got[r].get(case, got[r].get("init", ("error",
                                                           "not run")))
        assert status == "ok", f"rank {r}, {case}:\n{val}"
        out.append(val)
    return out


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_steps_match_the_reference(runs, name):
    steps_ = _result(runs, 4, name)[0]
    want_m, want_p = runs["ref"][name]
    for (got, *_), want in zip(steps_, want_m):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
    got_p = steps_[-1][2]
    assert len(got_p) == len(want_p) > 0
    for g, w in zip(got_p, want_p):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=LR)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_steps_match_the_unsharded_step(runs, name):
    """The tolerances of the module docstring's second item, each beside
    the worst reading over the six configs and two steps."""
    for i, (sharded, unsharded, got_p, want_p, got_m, want_m) in enumerate(
            _result(runs, 4, name)[0]):
        np.testing.assert_allclose(sharded[0], unsharded[0], rtol=1e-6)
        np.testing.assert_allclose(sharded[1], unsharded[1], rtol=1e-5)
        if i == 0:            # m = (1 - b1) g, v = (1 - b2) g²: the gradients
            for g, w in zip(got_m, want_m):
                assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max()
        n = off = 0
        for g, w in zip(got_p, want_p):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=LR)
            n += w.size
            off += int((np.abs(g - w) > 1e-6 + 1e-5 * np.abs(w)).sum())
        assert off * 4000 <= n, f"{off} of {n} elements off"


def test_sharded_logits_hold_only_the_local_batch(runs):
    """FSDP gathers the tied table before the unembedding: no rank's
    logits hold more rows than its own batch shard (DTensor's cheaper
    redistribution would move the activations onto the table's d shards
    and give every rank the logits of the whole batch)."""
    most, local = _result(runs, 4, "logit-rows")[0]
    assert most == local == 1


@pytest.mark.parametrize("arch", SERVE)
def test_sharded_serve_steps_match_the_unsharded_steps(runs, arch):
    """Prefill and decode on 2 x 2 (TP; the caches' sequence sharded, so
    the decode attention's softmax and p·v reduce across the shards):
    the same greedy tokens, logits within 1e-5 of their max and every
    cache element within 1e-5 (f32 sums in another order)."""
    same, logit_err, cache_err = _result(runs, 4, f"serve-{arch}")[0]
    assert same
    assert logit_err <= 1e-5 and cache_err <= 1e-5


def test_async_save_holds_the_state_at_the_save(runs):
    """A checkpoint saved with ``blocking=False`` and written after the
    next in-place AdamW step restores the state at the save, every leaf
    bit for bit, on both ranks; the next step changed some leaves."""
    for n, at_save, after in _result(runs, 2, "async-save"):
        assert n > 0 and at_save == n
        assert after < n


def test_elastic_restart_from_four_ranks_to_two(runs):
    """2 steps on 2 × 2, a checkpoint, 2 more on 2 × 1: the four losses
    are one process's four, and the checkpoint loads in the reference's
    ``CheckpointManager``."""
    import jax

    from repro import configs as jconfigs
    from repro.checkpoint import CheckpointManager
    from repro.models import transformer as jt
    from repro.optim import adamw_init as jadamw_init

    first = _result(runs, 4, "elastic")
    second = _result(runs, 2, "elastic")
    assert all(r[1] == 4 for r in first) and all(r[1] == 2 for r in second)
    losses = first[0][0] + second[0][0]
    assert len(losses) == 4
    for r in first + second:                 # every rank saw the same loss
        assert r[0] == (first[0][0] if r in first else second[0][0])
    np.testing.assert_allclose(losses, runs["whole"]["losses"], rtol=1e-3)
    jc = jconfigs.get_reduced("qwen2_0_5b")
    params, _ = jt.model_init(jax.random.PRNGKey(0), jc)
    step, tree, _ = CheckpointManager(runs["ckpt"]).restore_latest(
        {"params": params, "opt": jadamw_init(params)})
    assert step == 4 and int(tree["opt"].step) == 4
    assert all(np.isfinite(np.asarray(x, np.float32)).all()
               for x in jax.tree.leaves(tree))
