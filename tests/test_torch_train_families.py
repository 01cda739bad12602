"""The port's training path on the other model families, against the
reference's, on the CPU: the reduced ``llama4_scout_17b_a16e`` (MoE top-1
with a shared expert: the router's and the dispatch's backward, with
GShard capacity drops), ``deepseek_v2_lite_16b`` (MLA's latent
projections, the dense first layer ``prefix``, MoE top-2 with per-row
dispatch), ``llama_3_2_vision_11b`` (a cross-attention layer every 5th,
naive attention over the image K/V) and ``hubert_xlarge`` (frames in,
non-causal, the labels the tokens mod vocab), each with ``attn_remat`` on
as its config sets it.

Parameters come from the JAX ``model_init`` through the weight carry
(``test_torch_families._jax_params``) at f32; batches from the pipeline,
shaped as the trainer shapes them, with seeded frames and image
embeddings (``test_torch_train._train_batch``).  At f32 the MoE runs with
``moe_bf16_dispatch`` off, as ``tests/test_torch_families.py`` holds it
(llama4's knob rounds the expert products to bf16).  The capacity drops
are in play: on the first batch the reduced llama4's two MoE layers keep
0.94 and 0.66 of their assignments, deepseek's 0.92 (measured).

- the loss within rtol 1e-5 and every gradient leaf within 1e-4 of its
  max|value|, against ``jax.value_and_grad(lm.loss_fn)``, and the global
  norm of ``make_train_step`` within rtol 1e-4;
- three AdamW steps against the reference's jitted ``train_step``, at
  ``tests/test_torch_train.py``'s tolerances (and for the same reasons);
- ``train(..., device="cpu")`` for 8 steps at the config's bf16, with a
  finite loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import train
from repro_torch.optim import adamw_init
from repro_torch.optim.tree import leaves

from test_torch_families import FAMILIES, _cfgs
from test_torch_train import (LR, _batches, _params, _rel, _train_batch,
                              _two_threads)  # noqa: F401 (autouse fixture)


def _steps(arch, jc, n):
    """n trainer-shaped batches: (the port's, the reference's)."""
    out = []
    for s, hb in enumerate(_batches(arch, n)):
        tb = _train_batch(jc, hb, seed=s)
        out.append((tb, {k: jnp.asarray(v.numpy()) for k, v in tb.items()}))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_jax(arch):
    jc, tc = _cfgs(arch, f32=True)
    assert jc.attn_remat and tc.attn_remat
    jp, tp = _params(arch)
    (tb, jb), = _steps(arch, jc, 1)
    jl, jg = jax.value_and_grad(lambda p: jlm.loss_fn(p, jc, jb))(jp)
    tl, tg = tsteps.loss_and_grads(tp, tc, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = leaves(tg)
    assert len(got) == len(want) > 0
    for (path, w), g in zip(want, got):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        err = _rel(g.numpy(), w)
        assert err <= 1e-4, f"{jax.tree_util.keystr(path)}: {err:.3e}"
    _, tp2 = _params(arch)
    _, _, m = tsteps.make_train_step(tc, lr=LR)(tp2, adamw_init(tp2), tb)
    gn = float(jnp.sqrt(sum(jnp.sum(jnp.square(x))
                            for x in jax.tree.leaves(jg))))
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), gn, rtol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_three_train_steps_match_the_reference(arch):
    jc, tc = _cfgs(arch, f32=True)
    jp, tp = _params(arch)
    jstep = jax.jit(jmake_train_step(jc, lr=LR))
    tstep = tsteps.make_train_step(tc, lr=LR)
    jo, to = jadamw_init(jp), adamw_init(tp)
    for tb, jb in _steps(arch, jc, 3):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                                   rtol=1e-3)
    assert int(to.step) == int(jo.step) == 3
    for g, w in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=LR)
    for g, w in zip(leaves(to.m), jax.tree.leaves(jo.m)):
        assert _rel(g.numpy(), w) <= 1e-3


@pytest.mark.parametrize("arch", FAMILIES)
def test_trainer_takes_eight_steps(arch):
    m = train(arch, steps=8, batch=2, seq=32, log_every=100, device="cpu")
    assert m["steps"] == 8 and np.isfinite(m["final_loss"])
    assert np.isfinite(m["first_loss"]) and m["step_ms"] > 0
