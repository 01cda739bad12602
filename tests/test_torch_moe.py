"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX reference,
on the CPU.

Reduced ``llama4_scout_17b_a16e`` (4 experts, top-1, one shared expert,
``moe_bf16_dispatch``) and ``deepseek_v2_lite_16b`` (4 experts, top-2,
renormalised, two shared experts, ``moe_group_by_batch``), each with the
two knobs turned on and off.  Parameters come from the JAX ``moe_init``
through the weight carry; inputs from numpy with a seed.

- Routing is compared exactly: the chosen experts, the sort ``order``,
  ``pos``, ``keep`` and the buffer slots, against the reference's own
  lines (``src/repro/models/moe.py:90-110``) run in JAX, with a capacity
  factor that drops tokens and router rows with exact ties.
- f32 outputs within 1e-5 of max|y| (the two frameworks sum the products
  in different orders); bf16 within 2e-2 of max|y| (bf16 rounds at other
  places in the two frameworks).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models.layers import dense as jdense
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import moe as tmoe

ARCHS = ("llama4_scout_17b_a16e", "deepseek_v2_lite_16b")


def _cfgs(arch, **kw):
    return (jconfigs.get_reduced(arch).with_(**kw),
            tconfigs.get_reduced(arch).with_(**kw))


def _params(arch, seed=1):
    jc, _ = _cfgs(arch)
    p, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jc)
    return p


def _port(tree):
    return convert.tree_from_numpy(jax.tree.map(np.asarray, tree),
                                   device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_dispatch(p, cfg, xt):
    """The reference's routing and dispatch over one token group xt (T, D),
    line for line (``src/repro/models/moe.py:90-110``)."""
    m = cfg.moe
    T, _ = xt.shape
    E, K = m.n_experts, m.top_k
    logits = jdense(p["router"], xt.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, K)
    if m.router_norm_topk:
        top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    C = max(1, min(int(math.ceil(T * K / E * m.capacity_factor)), T))
    flat_e = top_e.reshape(T * K)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    pos = jnp.cumsum(jnp.ones_like(se)) - 1 \
        - jnp.searchsorted(se, jnp.arange(E, dtype=se.dtype))[se]
    keep = pos < C
    return {"top_p": top_p, "top_e": top_e, "order": order, "pos": pos,
            "keep": keep, "slot_e": jnp.where(keep, se, 0),
            "slot_c": jnp.where(keep, pos, C - 1), "C": C}


def _both_dispatches(p, jc, tc, x):
    """(jax, port) routing of x (B, S, D) as the config groups it, each a
    dict of numpy arrays with a leading group axis."""
    B, S, D = x.shape
    groups = x if jc.moe_group_by_batch else x.reshape(1, B * S, D)
    js = [jax_dispatch(p, jc, jnp.asarray(g)) for g in groups]
    want = {k: np.stack([np.asarray(j[k]) for j in js]) for k in js[0]
            if k != "C"}
    tp = _port(p)
    xt = torch.from_numpy(groups)
    top_p, top_e = tmoe.route(tp, tc, xt)
    C = tmoe.capacity(tc, groups.shape[1])
    assert C == js[0]["C"]
    got = {k: v.numpy() for k, v in tmoe.dispatch(top_e, tc.moe.n_experts,
                                                  C).items()}
    got["top_p"], got["top_e"] = top_p.numpy(), top_e.numpy()
    return want, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_dispatch", [False, True])
@pytest.mark.parametrize("by_batch", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, by_batch, bf16_dispatch, dtype):
    jc, tc = _cfgs(arch, moe_group_by_batch=by_batch,
                   moe_bf16_dispatch=bf16_dispatch)
    p = _params(arch)
    if dtype == "float32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    x = jnp.asarray(_x(2, (2, 24, jc.d_model))).astype(dtype)
    want = jmoe.moe_apply(p, jc, x)
    got = tmoe.moe_apply(_port(p), tc, convert.tree_from_numpy(
        np.asarray(x), device="cpu"))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert _rel(got.float(), want.astype(jnp.float32)) < (
        1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("by_batch", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_equals_reference_exactly(arch, by_batch, factor):
    """The chosen experts, sort order, positions, keep mask and slots,
    element for element; at a capacity factor of 0.5 tokens drop, the
    same in both."""
    import dataclasses

    jc, tc = _cfgs(arch, moe_group_by_batch=by_batch)
    jc = jc.with_(moe=dataclasses.replace(jc.moe, capacity_factor=factor))
    tc = tc.with_(moe=dataclasses.replace(tc.moe, capacity_factor=factor))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), _params(arch))
    want, got = _both_dispatches(p, jc, tc, _x(3, (2, 24, jc.d_model)))
    for k in ("top_e", "order", "pos", "keep", "slot_e", "slot_c"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["top_p"], want["top_p"], rtol=1e-6)
    if factor < 1:
        assert not want["keep"].all()


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_go_to_the_lower_expert(arch):
    """Rows of zeros give every expert the same probability, and a router
    whose column 3 copies column 1 ties experts 1 and 3 on every token:
    both packages pick the lower id, and expert 3 never wins a tie."""
    jc, tc = _cfgs(arch)
    p = jax.tree.map(lambda a: a.astype(jnp.float32), _params(arch))
    w = np.asarray(p["router"]["w"]).copy()
    w[:, 3] = w[:, 1]
    p = dict(p, router={"w": jnp.asarray(w)})
    x = _x(4, (2, 24, jc.d_model))
    x[:, ::5] = 0.0
    tp = _port(p)
    probs = tmoe.router_probs(tp, torch.from_numpy(x))
    assert torch.equal(probs[..., 1], probs[..., 3])
    want, got = _both_dispatches(p, jc, tc, x)
    np.testing.assert_array_equal(got["top_e"], want["top_e"])
    K = jc.moe.top_k
    top = got["top_e"].reshape(-1, K)
    zero = (x == 0).all(-1).reshape(-1)
    np.testing.assert_array_equal(top[zero], np.tile(np.arange(K),
                                                     (zero.sum(), 1)))
    first3 = top[:, 0] == 3
    assert not first3.any()
    assert (top[:, 0] == 1).any()


def test_capacity_drops_add_nothing():
    """At a capacity factor small enough that most assignments drop, the
    routed output of a token whose every pick dropped is zero in both
    packages (the shared expert carries it)."""
    import dataclasses

    arch = "llama4_scout_17b_a16e"
    jc, tc = _cfgs(arch)
    jc = jc.with_(moe=dataclasses.replace(jc.moe, capacity_factor=0.25,
                                          n_shared=0))
    tc = tc.with_(moe=dataclasses.replace(tc.moe, capacity_factor=0.25,
                                          n_shared=0))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), _params(arch))
    p = {k: v for k, v in p.items() if not k.startswith("sh_")}
    x = _x(5, (2, 24, jc.d_model))
    want = np.asarray(jmoe.moe_apply(p, jc, jnp.asarray(x)))
    got = tmoe.moe_apply(_port(p), tc, torch.from_numpy(x)).numpy()
    d, _ = _both_dispatches(p, jc, tc, x)
    kept = np.zeros(48, bool)
    kept[d["order"][0][d["keep"][0]] // jc.moe.top_k] = True
    assert (~kept).any() and kept.any()
    flat_w, flat_g = want.reshape(48, -1), got.reshape(48, -1)
    assert (flat_w[~kept] == 0).all() and (flat_g[~kept] == 0).all()
    assert _rel(got, want) < 1e-5
