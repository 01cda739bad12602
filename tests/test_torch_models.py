"""The port's dense decoder model stack against the JAX reference, on the CPU.

Reduced ``qwen2_0_5b``, ``yi_6b`` and ``gemma2_2b`` (gemma2 brings a local
layer with window 16, both softcaps, the sandwich norms, gelu-tanh and the
scaled embedding).  Parameters come from the JAX ``model_init`` through
the weight carry (``repro_torch.models.convert``); tokens from numpy with a
seed.  Tolerances, each with its reason:

- f32 parameters (both trees cast), where the algorithm is the point:
  logits within 1e-4 of max|logit| (the two frameworks sum matmuls and
  the online softmax in different orders; ~1e-6 is measured), caches within
  1e-5 absolute (K/V of unit scale, f32).
- bf16 parameters, the real dtype: the loss within 5e-3, the bound of
  ``tests/test_models.py:164-165``; logits within 2e-2 of max|logit| and
  K/V caches within two bf16 ulps (bf16 rounds at other places in the two
  frameworks).
- ``DecodeExecutor`` tokens exactly equal, at f32 parameters and caches so
  that no bf16 tie can flip a token.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import DecodeExecutor
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tt

DENSE = ("qwen2_0_5b", "yi_6b", "gemma2_2b")
OUTSIDE = ("llama4_scout_17b_a16e", "deepseek_v2_lite_16b",
           "llama_3_2_vision_11b", "hubert_xlarge")
IMPLS = ("naive", "xla_chunked", "pallas")
CPU = torch.device("cpu")


def _cfgs(arch, **kw):
    return (jconfigs.get_reduced(arch).with_(**kw),
            tconfigs.get_reduced(arch).with_(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, n_layers=None, seed=0):
    jc, _ = _cfgs(arch)
    if n_layers:
        jc = jc.with_(n_layers=n_layers)
    params, _ = jt.model_init(jax.random.PRNGKey(seed), jc)
    return params


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _port(tree, tc):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), tc,
                                     device=CPU)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _caches_close(tcache, jcache, **tol):
    got = jax.tree.leaves(tcache)
    want = jax.tree.leaves(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jcache))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------------------
# the configuration registry is the reference's
# ---------------------------------------------------------------------------
def test_config_registry_equals_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        for get in ("get", "get_reduced"):
            a = dataclasses.asdict(getattr(jconfigs, get)(arch))
            b = dataclasses.asdict(getattr(tconfigs, get)(arch))
            assert a == b, arch
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.cells() == jconfigs.cells()


# ---------------------------------------------------------------------------
# the full-sequence forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_train_logits_match_jax_at_f32(arch, impl):
    """S = 40: ragged against the 16-wide chunks, and past gemma2's
    reduced window of 16, so the window cuts."""
    jc, tc = _cfgs(arch, attention_impl=impl)
    params = _f32(_jax_params(arch))
    toks = _tokens(1, (2, 40), jc.vocab)
    want, _ = jt.model_apply(params, jc, {"tokens": jnp.asarray(toks)})
    before = flash_attention.launches
    got, cache = tt.model_apply(_port(params, tc), tc,
                                {"tokens": torch.from_numpy(toks)})
    assert flash_attention.launches == before      # the CPU runs no kernel
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (2, 40, jc.vocab)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("impl", ["xla_chunked", "pallas"])
@pytest.mark.parametrize("loss_chunk", [0, 16])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_matches_jax_at_bf16(arch, loss_chunk, impl):
    """bf16 weights as ``model_init`` makes them; ``loss_chunk`` 16 takes
    the chunked path over 40 tokens (two full chunks and a padded one)."""
    jc, tc = _cfgs(arch, attention_impl=impl, loss_chunk=loss_chunk)
    params = _jax_params(arch)
    toks = _tokens(2, (2, 40), jc.vocab)
    labels = _tokens(3, (2, 40), jc.vocab)
    want = float(jlm.loss_fn(params, jc, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)}))
    got = tlm.loss_fn(_port(params, tc), tc,
                      {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32
    assert abs(float(got) - want) < 5e-3


def test_weight_carry_keeps_layer_order():
    """Gemma2 reduced to 5 layers: two full (local, full) periods stacked
    on axis 0 and one remainder layer.  Swapping two stacked layers in the
    carried tree changes the logits: the order is read, not ignored."""
    jc, tc = _cfgs("gemma2_2b", n_layers=5)
    assert (tc.n_full_periods, tc.n_remainder) == (2, 1)
    params = _f32(_jax_params("gemma2_2b", n_layers=5))
    toks = _tokens(4, (1, 24), jc.vocab)
    want, _ = jt.model_apply(params, jc, {"tokens": jnp.asarray(toks)})
    tp = _port(params, tc)
    got, _ = tt.model_apply(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) < 1e-4
    tp["stack"][0]["mixer"]["q"]["w"] = tp["stack"][0]["mixer"]["q"]["w"][
        [1, 0]]
    swapped, _ = tt.model_apply(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert _rel(swapped, want) > 1e-3
    with pytest.raises(ValueError):
        convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                  tc.with_(n_layers=4), device=CPU)


@pytest.mark.parametrize("arch", DENSE)
def test_count_params_equals_reference(arch):
    jc, tc = _cfgs(arch)
    params = _jax_params(arch)
    assert tt.count_params(_port(params, tc)) == jt.count_params(params)
    own = tt.model_init(0, tc, device=CPU)
    assert tt.count_params(own) == jt.count_params(params)
    same = jax.tree.map(lambda a: (a.shape, str(a.dtype)), params)
    mine = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]),
                        own)
    assert jax.tree.leaves(mine) == jax.tree.leaves(same)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _serve_steps(arch, prompt, n_steps, dtype):
    """Prefill ``prompt`` then decode ``n_steps`` seeded tokens in both
    packages; yields (what, port logits, jax logits, port cache, jax
    cache) after each step, the port's cache (updated in place) as a
    numpy copy."""
    jc, tc = _cfgs(arch)
    max_len = 24
    params = _jax_params(arch)
    jcache = jt.init_cache(jc, 2, max_len)
    if dtype == "float32":
        params, jcache = _f32(params), _f32(jcache)
    tp = _port(params, tc)
    tcache = tt.init_cache(tc, 2, max_len, dtype=getattr(torch, dtype),
                           device=CPU)
    toks = _tokens(5, (2, prompt), jc.vocab)
    jl, jcache = jlm.make_prefill(jc)(params, {"tokens": jnp.asarray(toks)},
                                      jcache)
    tl, tcache = tlm.make_prefill(tc)(tp, {"tokens": torch.from_numpy(toks)},
                                      tcache)
    yield "prefill", tl, jl, convert.tree_to_numpy(tcache), jcache
    feed = _tokens(6, (n_steps, 2, 1), jc.vocab)
    for t in range(n_steps):
        jn, jl, jcache = jlm.make_decode_step(jc)(
            params, jcache, jnp.int32(prompt + t), jnp.asarray(feed[t]))
        tn, tl, tcache = tlm.make_decode_step(tc)(
            tp, tcache, prompt + t, torch.from_numpy(feed[t]))
        assert tn.dtype == torch.int32
        if dtype == "float32":
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        yield f"decode {t}", tl, jl, convert.tree_to_numpy(tcache), jcache


# (arch, prompt): gemma2's local cache holds window + 1 = 17 slots, so a
# 20-token prompt wraps the ring at prefill and the decode steps go on
# around it
SERVE_CASES = [("qwen2_0_5b", 12), ("yi_6b", 12), ("gemma2_2b", 12),
               ("gemma2_2b", 20)]


@pytest.mark.parametrize("arch,prompt", SERVE_CASES)
def test_prefill_and_decode_match_jax_at_f32(arch, prompt):
    steps = list(_serve_steps(arch, prompt, 4, "float32"))
    assert len(steps) == 5
    for what, tl, jl, tcache, jcache in steps:
        assert _rel(tl, jl) < 1e-4, what
        _caches_close(tcache, jcache, atol=1e-5, rtol=1e-5)
    if prompt == 20:
        local = steps[-1][3]["stack"][0]["mixer"]["k"]
        assert local.shape[2] == 17        # (periods, B, window + 1, K, hd)


@pytest.mark.parametrize("arch,prompt", SERVE_CASES)
def test_prefill_and_decode_match_jax_at_bf16(arch, prompt):
    for what, tl, jl, tcache, jcache in _serve_steps(arch, prompt, 4,
                                                     "bfloat16"):
        assert _rel(tl, jl) < 2e-2, what
        # two bf16 ulps at the K/V magnitudes (|x| < 8: ulp <= 2^-5)
        _caches_close(tcache, jcache, atol=2 * 2 ** -5, rtol=2 * 2 ** -8)


def test_decode_continues_from_a_carried_jax_cache():
    """The cache carry: the JAX prefill's cache, carried into the port,
    decodes to the JAX decode step's logits and cache."""
    jc, tc = _cfgs("gemma2_2b")
    params = _f32(_jax_params("gemma2_2b"))
    toks = _tokens(9, (2, 20), jc.vocab)
    _, jcache = jlm.make_prefill(jc)(params, {"tokens": jnp.asarray(toks)},
                                     _f32(jt.init_cache(jc, 2, 24)))
    tcache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), tc,
                                      device=CPU)
    last = _tokens(10, (2, 1), jc.vocab)
    _, jl, jcache = jlm.make_decode_step(jc)(params, jcache, jnp.int32(20),
                                             jnp.asarray(last))
    _, tl, tcache = tlm.make_decode_step(tc)(_port(params, tc), tcache, 20,
                                             torch.from_numpy(last))
    assert _rel(tl, jl) < 1e-4
    _caches_close(convert.tree_to_numpy(tcache), jcache, atol=1e-5,
                  rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_executor_tokens_match_jax(arch, monkeypatch):
    """Three requests of different prompt lengths (left-padded with token
    0) and token counts through both executors, at f32 parameters and f32
    caches (the JAX executor's bf16 cache is swapped for an f32 one)."""
    jc, tc = _cfgs(arch)
    params = _f32(_jax_params(arch))
    make_cache = jt.init_cache
    monkeypatch.setattr(jserve.transformer, "init_cache",
                        lambda *a: _f32(make_cache(*a)))
    jex = jserve.DecodeExecutor(jc, max_batch=4, max_len=32, seed=0)
    jex.params = params
    tex = DecodeExecutor(tc, max_batch=4, max_len=32, device=CPU,
                         params=_port(params, tc),
                         cache_dtype=torch.float32)
    rng = np.random.default_rng(7)
    reqs = [{"prompt": rng.integers(1, jc.vocab, n).astype(np.int32),
             "n_tokens": g} for n, g in ((9, 5), (14, 3), (4, 6))]
    want = jex(reqs)
    got = tex(reqs)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert tex.device_steps == jex.device_steps == 7


def test_decode_executor_keeps_step_logits():
    jc, tc = _cfgs("qwen2_0_5b")
    tex = DecodeExecutor(tc, max_batch=2, max_len=16, device=CPU,
                         keep_logits=True)
    out = tex([{"prompt": np.arange(1, 6, dtype=np.int32), "n_tokens": 3}])
    assert len(tex.step_logits) == 4
    assert all(t.shape == (2, tc.vocab) for t in tex.step_logits)
    # each step's greedy token is the argmax of the logits before it
    assert out[0].tolist() == [int(torch.argmax(t[0]))
                               for t in tex.step_logits[:3]]


# ---------------------------------------------------------------------------
# what the slice does not build
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", OUTSIDE)
def test_families_outside_the_slice_raise(arch):
    for get in (tconfigs.get, tconfigs.get_reduced):
        cfg = get(arch)
        with pytest.raises(NotImplementedError, match="ROADMAP A1[2-6]"):
            tt.model_init(0, cfg, device=CPU)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tt.init_cache(cfg, 1, 8, device=CPU)


def test_unknown_attention_impl_raises():
    _, tc = _cfgs("qwen2_0_5b", attention_impl="flash")
    params = tt.model_init(0, tc, device=CPU)
    with pytest.raises(ValueError, match="attention_impl"):
        tt.model_apply(params, tc, {"tokens": torch.zeros((1, 4),
                                                          dtype=torch.int32)})


# ---------------------------------------------------------------------------
# On the card: the kernel path against the plain blockwise path
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 logits compared
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", DENSE)
def test_cuda_kernel_path_matches_plain_path(cuda, arch):
    """At f32 weights (the drawn bf16 ones upcast), where the algorithm is
    the point: within 1e-4 of max|logit| (the module's f32 tolerance)."""
    _, tc = _cfgs(arch)
    params = jax.tree.map(lambda t: t.float(),
                          tt.model_init(0, tc, device=cuda))
    toks = torch.from_numpy(_tokens(8, (2, 40), tc.vocab)).to(cuda)
    before = flash_attention.launches
    got, _ = tt.model_apply(params, tc.with_(attention_impl="pallas"),
                            {"tokens": toks})
    assert flash_attention.launches == before + tc.n_layers
    want, _ = tt.model_apply(params, tc.with_(attention_impl="xla_chunked"),
                             {"tokens": toks})
    assert _rel(got.cpu(), want.cpu()) < 1e-4
