"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the JAX reference, on the CPU.

Reduced ``deepseek_v2_lite_16b`` (kv_lora_rank 32, rope 16, nope 32, v 32,
q/k 48 wide against v 32: the head widths differ, as at full width, 192
against 128).  Parameters come from the JAX ``mla_init`` through the
weight carry; inputs from numpy with a seed.  Tolerances as
``tests/test_torch_models.py``'s: at f32 the outputs within 1e-4 of
max|y| and the ``c`` and ``kr`` caches within 1e-5; at bf16 the outputs
within 2e-2 of max|y|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mla as jmla
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import mla as tmla

ARCH = "deepseek_v2_lite_16b"
PROMPT, STEPS, MAX_LEN = 20, 4, 32


def _setup(dtype):
    jc = jconfigs.get_reduced(ARCH)
    tc = tconfigs.get_reduced(ARCH)
    lspec = jc.period[0]
    assert lspec.mixer == "mla"
    p, _ = jmla.mla_init(jax.random.PRNGKey(2), jc, lspec)
    p = jax.tree.map(lambda a: a.astype(dtype), p)
    tp = convert.tree_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    x = np.random.default_rng(3).standard_normal(
        (2, PROMPT + STEPS, jc.d_model)).astype(np.float32)
    return jc, tc, lspec, p, tp, jnp.asarray(x).astype(dtype)


def _t(a):
    return convert.tree_from_numpy(np.asarray(a), device="cpu")


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_train_matches_jax(dtype, tol):
    jc, tc, lspec, p, tp, x = _setup(dtype)
    S = x.shape[1]
    want, _ = jmla.mla_apply(p, jc, lspec, x, positions=jnp.arange(S))
    got = tmla.mla_apply(tp, tc, lspec, _t(x), positions=torch.arange(S))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert _rel(got, want.astype(jnp.float32)) < tol


# the reference's absorbed decode asks XLA:CPU for a bf16 x bf16 -> f32
# product, which its CPU backend does not run: absorb at f32 only
@pytest.mark.parametrize("absorb,dtype", [(False, "float32"),
                                          (False, "bfloat16"),
                                          (True, "float32")])
def test_prefill_and_decode_match_jax(absorb, dtype):
    """Prefill PROMPT tokens into an empty cache, then decode STEPS tokens
    one by one (``absorb`` as given): every output and, at f32, both
    caches after every step."""
    jc, tc, lspec, p, tp, x = _setup(dtype)
    jcache = jmla.mla_cache_init(jc, 2, MAX_LEN, dtype=dtype)
    tcache = tmla.mla_cache_init(tc, 2, MAX_LEN, getattr(torch, dtype),
                                 device=torch.device("cpu"))
    tol = 1e-4 if dtype == "float32" else 2e-2
    xp = x[:, :PROMPT]
    want, jcache = jmla.mla_apply(p, jc, lspec, xp,
                                  positions=jnp.arange(PROMPT),
                                  cache=jcache, cache_len=jnp.int32(0),
                                  mode="prefill")
    got = tmla.mla_apply(tp, tc, lspec, _t(xp),
                         positions=torch.arange(PROMPT), cache=tcache,
                         cache_len=0, mode="prefill")
    steps = [("prefill", got, want)]
    for t in range(STEPS):
        pos = PROMPT + t
        xs = x[:, pos:pos + 1]
        want, jcache = jmla.mla_apply(
            p, jc, lspec, xs, positions=jnp.reshape(jnp.int32(pos), (1,)),
            cache=jcache, cache_len=jnp.int32(pos), mode="decode",
            absorb=absorb)
        got = tmla.mla_apply(tp, tc, lspec, _t(xs),
                             positions=torch.tensor([pos]), cache=tcache,
                             cache_len=pos, mode="decode", absorb=absorb)
        steps.append((f"decode {t}", got, want))
        if dtype == "float32":
            for k in ("c", "kr"):
                np.testing.assert_allclose(tcache[k].numpy(),
                                           np.asarray(jcache[k]),
                                           atol=1e-5, rtol=1e-5, err_msg=k)
    for what, got, want in steps:
        assert got.dtype == getattr(torch, dtype), what
        assert _rel(got, want.astype(jnp.float32)) < tol, what
    # positions past the last decode step stay unwritten
    assert not tcache["c"][:, PROMPT + STEPS:].any()


def test_absorbed_decode_equals_the_expanded_one():
    """The two decode forms are one function: at f32 the absorbed step's
    output within 1e-5 of max|y| of the expanded step's."""
    _, tc, lspec, _, tp, x = _setup("float32")
    outs = []
    for absorb in (False, True):
        cache = tmla.mla_cache_init(tc, 2, MAX_LEN, torch.float32,
                                    device=torch.device("cpu"))
        tmla.mla_apply(tp, tc, lspec, _t(x[:, :PROMPT]),
                       positions=torch.arange(PROMPT), cache=cache,
                       cache_len=0, mode="prefill")
        outs.append(tmla.mla_apply(
            tp, tc, lspec, _t(x[:, PROMPT:PROMPT + 1]),
            positions=torch.tensor([PROMPT]), cache=cache,
            cache_len=PROMPT, mode="decode", absorb=absorb))
    assert _rel(outs[1], outs[0].numpy()) < 1e-5
