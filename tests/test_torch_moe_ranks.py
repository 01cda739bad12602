"""The port's MoE dispatch on a mesh (``models/moe.py`` on DTensors)
across four spawned gloo ranks, against the JAX package's unsharded train
step and the port's own unsharded steps.

The harness is ``tests/test_torch_sharded_ranks.py``'s: one spawned job
of four ranks (``torch.multiprocessing``, the spawn start method, a
``FileStore`` under ``tmp_path``, one thread a rank, a 60 s gloo timeout
and a job deadline that kills the ranks), every case on every rank,
SPMD.  The reduced configs at f32 with ``moe_bf16_dispatch`` off, the
reference's ``model_init`` weights and the pipeline's batches (4 × 32):

- (a) ``llama4_scout_17b_a16e`` on 2 × 2 with ``seq_shard``: the batch
  over data, FSDP on data, the experts over model (each model rank runs
  its own experts on its data row's tokens);
- (b) ``llama4_scout_17b_a16e`` with ``pure_dp`` on 2 × 2: the batch over
  data × model, so the global token order, and the capacity's prefix,
  run over two mesh dims;
- (c) ``deepseek_v2_lite_16b`` on 2 × 2 (``moe_group_by_batch``: each row
  a group, whole on its rank);
- (d) the llama4 serving layout (``moe_ep_serve``: the experts over data,
  their FFN dim over model) on 2 × 2: a prefill of 4 × 12 and 4 decode
  steps through the mesh steps against the unsharded steps (the kept rows
  exchanged with ``all_to_all`` over data, the down-projection's partial
  sums reduced over model);
- two faults the MoE configs were the first to reach on a mesh: (e)
  ``llama4_scout_17b_a16e`` trained on 1 × 4, its 10 query heads whole on
  each of the 4 model ranks (as the full config's 40 heads on a 16-wide
  axis): the output projection's gradient, sharded over H·hd, must be
  laid out whole before the view back to heads; (f) ``deepseek_v2_lite_16b``
  served on 2 × 2 (the experts over model), the reference's cache specs
  sharding MLA's latent cache over its sequence: the decode step gathers
  it before the expansion's flattened product.

For (a)-(c) and (e), two AdamW steps through ``make_train_step(cfg, mesh)``
against the reference's jitted unsharded ``make_train_step`` (computed in
the parent while the ranks run) and against the port's unsharded step on
the same weights, at ``tests/test_torch_sharded_ranks.py``'s tolerances
and for its reasons (a sharded step sums the same terms in another
order): the loss within rtol 1e-5 and the global norm within 1e-3 of the
reference's, the parameters within rtol 1e-5 plus lr; against the port's
unsharded step the loss within rtol 1e-6, the norm within 1e-5, the
first step's moments within 2e-5 of each leaf's largest, and at most one
parameter element in 4,000 beyond rtol 1e-5 plus 1e-6 absolute.

In every case each MoE layer's kept set (each (token, k) pick kept or
dropped, gathered over the ranks into the global batch's order) equals
the unsharded one exactly.  The test can fail: on (a)'s first batch the
global capacity drops assignments, and a capacity counted on each data
shard alone would keep a different set.
"""
import numpy as np
import pytest
import torch

from test_torch_sharded_ranks import _Job, _numpy, _result

LR = 1e-3
B, S = 4, 32
# name -> (arch, model axis of the 4 ranks, config overrides)
TRAIN = {
    "llama4-seq_shard": ("llama4_scout_17b_a16e", 2, {"seq_shard": True}),
    "llama4-pure_dp": ("llama4_scout_17b_a16e", 2, {"pure_dp": True}),
    "deepseek": ("deepseek_v2_lite_16b", 2, {}),
    "llama4-whole_heads": ("llama4_scout_17b_a16e", 4, {}),
}
# name -> arch, served on 2 x 2
SERVE = {"llama4-serve": "llama4_scout_17b_a16e",
         "deepseek-serve": "deepseek_v2_lite_16b"}


# ---------------------------------------------------------------------------
# The cases (run inside every rank)
# ---------------------------------------------------------------------------
class _Kept:
    """Records each dispatch's keep flags in (token, k) order (the model's
    ``moe.dispatch`` wrapped), and each call's chosen experts."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls = moe, []

    def __enter__(self):
        dispatch = self.dispatch = self.moe.dispatch

        def probed(top_e, n_experts, C, start=None):
            d = dispatch(top_e, n_experts, C, start)
            kept = torch.empty_like(d["keep"])
            kept.scatter_(-1, d["order"], d["keep"])
            self.calls.append((kept.reshape(top_e.shape).clone(),
                               top_e.clone()))
            return d

        self.moe.dispatch = probed
        return self

    def __exit__(self, *exc):
        self.moe.dispatch = self.dispatch

    def rows(self, batch):
        """Each call's (keep, experts), (batch, -1, K) numpy."""
        return [tuple(t.reshape(batch, -1, t.shape[-1]).numpy() for t in c)
                for c in self.calls]


def _whole(kept, cfg, mesh, batch):
    """Every rank's recorded calls put together in the global batch's
    order (rank 0 returns them; the others ``None``): each rank's rows
    are its batch shard's, the shard index over the dp axes that shard
    ``batch`` rows (``launch/sharding.py``'s rule)."""
    import torch.distributed as dist

    from repro_torch.launch import sharding as sh
    from repro_torch.optim.tree import shard_index

    dp, _ = sh._axes_for(cfg, mesh)
    axes = sh._dp_for(batch, dp, mesh) or ()
    idx, n = shard_index(mesh, [a in axes for a in mesh.mesh_dim_names])
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (idx, kept.rows(batch // n)))
    if dist.get_rank():
        return None
    by = dict(got)
    return [tuple(np.concatenate([by[i][c][j] for i in range(n)])
                  for j in range(2)) for c in range(len(by[0]))]


def case_train(name, init, batches):
    """Two sharded steps beside two unsharded ones on the same weights:
    per step (sharded metrics, unsharded metrics, sharded and unsharded
    parameter leaves, sharded and unsharded moment leaves), and each
    MoE call's (keep, experts), sharded (gathered) and unsharded."""
    from repro_torch import configs
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for_world
    from repro_torch.models import convert
    from repro_torch.optim import adamw_init

    arch, mp, kw = TRAIN[name]
    mesh = make_mesh_for_world(4, model_parallel=mp, device="cpu")
    cfg = configs.get_reduced(arch).with_(moe_bf16_dispatch=False, **kw)
    pu = convert.params_from_numpy(init, cfg, device="cpu")
    pd = sh.distribute_tree(convert.params_from_numpy(init, cfg,
                                                      device="cpu"),
                            sh.param_specs(cfg, mesh, "train"), mesh)
    ou, od = adamw_init(pu), adamw_init(pd)
    unsharded = steps.make_train_step(cfg, lr=LR)
    sharded = steps.make_train_step(cfg, mesh, lr=LR)
    out = []
    for hb in batches:
        b = {k: torch.from_numpy(v) for k, v in hb.items()}
        with _Kept() as ku:
            pu, ou, mu = unsharded(pu, ou, dict(b))
        with _Kept() as kd:
            pd, od, md = sharded(pd, od, dict(b))
        out.append(((float(md["loss"]), float(md["gnorm"])),
                    (float(mu["loss"]), float(mu["gnorm"])),
                    _numpy(sh.gather_tree(pd)), _numpy(pu),
                    _numpy(sh.gather_tree((od.m, od.v))),
                    _numpy((ou.m, ou.v)),
                    _whole(kd, cfg, mesh, B), ku.rows(B)))
    return out


def case_serve(name):
    """The serving layout on 2 x 2 (llama4: experts over data, F over
    model; deepseek: experts over model): a prefill of 4 x 12 and 4
    decode steps through the mesh steps beside the unsharded steps, at
    f32: (greedy tokens equal, worst logit difference over the logits'
    largest, worst cache difference, each call's (keep, experts) sharded
    (gathered) and unsharded)."""
    from repro_torch import configs
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for_world
    from repro_torch.models import transformer
    from repro_torch.optim.tree import leaves, tree_map

    P, N = 12, 4
    mesh = make_mesh_for_world(4, model_parallel=2, device="cpu")
    cfg = configs.get_reduced(SERVE[name]).with_(
        moe_bf16_dispatch=False, decode_cache_len=P + N)
    params = tree_map(lambda t: t.float(),
                      transformer.model_init(0, cfg, device="cpu"))
    specs = sh.param_specs(cfg, mesh, "serve")
    assert tuple(specs["stack"][0]["ffn"]["w_up"]) == (
        (None, "data", None, "model") if cfg.moe_ep_serve
        else (None, "model", None, None))
    shapes = sh.cache_shapes(cfg, B, P + N)
    toks = torch.randint(0, cfg.vocab, (B, P),
                         generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32)
    got = {}
    for m in (None, mesh):
        p = params if m is None else sh.distribute_tree(params, specs, m)
        cache = transformer.init_cache(cfg, B, P + N, device="cpu",
                                       dtype=torch.float32)
        if m is not None:
            cache = sh.distribute_tree(cache, sh.cache_specs(cfg, m, shapes),
                                       m)
        with _Kept() as kept:
            last, cache = steps.make_prefill_step(cfg, m)(
                p, {"tokens": toks}, cache)
            last = sh.gather_tree(last)
            nxt = torch.argmax(last, -1).to(torch.int32)
            out = [nxt]
            for i in range(N):
                nxt, cache = steps.make_decode_step(cfg, m)(
                    p, cache, P + i, {"tokens": nxt[:, None]})
                nxt = sh.gather_tree(nxt)
                out.append(nxt)
        calls = kept.rows(B) if m is None else _whole(kept, cfg, m, B)
        got[m is None] = (last, torch.stack(out, 1),
                          [t.clone() for t in leaves(sh.gather_tree(cache))],
                          calls)
    (lu, tu, cu, ku), (ld, td, cd, kd) = got[True], got[False]
    return (bool(torch.equal(tu, td)),
            float((lu - ld).abs().max() / lu.abs().max()),
            max(float((a - b).abs().max()) for a, b in zip(cu, cd)),
            kd, ku)


def _cases(world, payload):
    out = [(n, lambda n=n: case_train(n, payload["init"][n],
                                       payload["batches"][n]))
           for n in TRAIN]
    return out + [(n, lambda n=n: case_serve(n)) for n in SERVE]


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------
def _reference(name, init, batches):
    """The JAX package's two unsharded steps: (loss, gnorm) a step and
    the leaves after the last."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.optim import adamw_init as jadamw_init

    arch, _, kw = TRAIN[name]
    jc = jconfigs.get_reduced(arch).with_(moe_bf16_dispatch=False, **kw)
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

    tmp = str(tmp_path_factory.mktemp("moe"))
    init, batches = {}, {}
    for name, (arch, _, _) in TRAIN.items():
        jp, _ = _params(arch)
        init[name] = jax.tree.map(np.asarray, jp)
        batches[name] = _batches(arch, 2, batch=B, seq=S)
    job = _Job(4, tmp, {"init": init, "batches": batches},
               cases=_cases)
    ref = {n: _reference(n, init[n], batches[n]) for n in TRAIN}
    return {"ref": ref, 4: job.join()}


def _kept_equal(sharded, unsharded):
    assert len(sharded) == len(unsharded) > 0
    for i, ((kd, ed), (ku, eu)) in enumerate(zip(sharded, unsharded)):
        assert np.array_equal(ed, eu), f"call {i}: other experts chosen"
        assert np.array_equal(kd, ku), \
            f"call {i}: {int((kd != ku).sum())} picks kept otherwise"


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_moe_steps_match_the_reference(runs, name):
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


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_moe_steps_match_the_unsharded_step(runs, name):
    for i, (sharded, unsharded, got_p, want_p, got_m, want_m, _, _) in \
            enumerate(_result(runs, 4, name)[0]):
        np.testing.assert_allclose(sharded[0], unsharded[0], rtol=1e-6)
        np.testing.assert_allclose(sharded[1], unsharded[1], rtol=1e-5)
        if i == 0:
            for g, w in zip(got_m, want_m):
                assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max()
        n = off = 0
        for g, w in zip(got_p, want_p):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=LR)
            n += w.size
            off += int((np.abs(g - w) > 1e-6 + 1e-5 * np.abs(w)).sum())
        assert off * 4000 <= n, f"{off} of {n} elements off"


@pytest.mark.parametrize("name", list(TRAIN) + list(SERVE))
def test_sharded_kept_sets_equal_the_unsharded(runs, name):
    """Each MoE call's chosen experts and kept picks, over the global
    batch, are the unsharded dispatch's exactly (every forward of the
    two steps; the prefill and each decode step)."""
    res = _result(runs, 4, name)[0]
    if name in SERVE:
        _kept_equal(res[3], res[4])
        return
    for step in res:
        _kept_equal(step[6], step[7])


def test_the_global_capacity_decides_the_kept_set(runs):
    """On (a)'s first batch the global capacity drops assignments, and a
    capacity counted on each data shard's tokens alone (the dispatch run
    on each shard by itself) keeps another set: a per-shard dispatch
    would fail the kept-set test."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get_reduced("llama4_scout_17b_a16e")
    calls = _result(runs, 4, "llama4-seq_shard")[0][0][7]
    assert len(calls) == 2                       # one a MoE layer
    dropped = per_shard_differs = 0
    for keep, experts in calls:
        dropped += int((~keep).sum())
        per = []
        for shard in np.split(torch.from_numpy(experts), 2):  # data = 2
            top_e = shard.reshape(1, -1, shard.shape[-1])
            d = moe.dispatch(top_e, cfg.moe.n_experts,
                             moe.capacity(cfg, top_e.shape[1]))
            kept = torch.empty_like(d["keep"])
            kept.scatter_(-1, d["order"], d["keep"])
            per.append(kept.reshape(shard.shape).numpy())
        per_shard_differs += int((np.concatenate(per) != keep).sum())
    assert dropped > 0
    assert per_shard_differs > 0


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_serve_matches_the_unsharded_steps(runs, name):
    """(d), (f): the same greedy tokens, logits within 1e-5 of their max
    and every cache element within 1e-5 (f32 sums in another order)."""
    same, logit_err, cache_err, _, _ = _result(runs, 4, name)[0]
    assert same
    assert logit_err <= 1e-5 and cache_err <= 1e-5
