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
def local_window(cfg):
    """The narrowest local-attention window of ``cfg`` (0: none)."""
    return min((s.window for s in cfg.period if s.mixer == "local"),
               default=0)


def jax_past_the_window(cfg, params, seq, fresh):
    """The JAX reference for a decode step that finds a local layer's ring
    full, where the reference's decode attends every slot of its window + 1
    ring, one position more than its own full-sequence forward, and the
    port's decode the forward's window.  A function of a decode position
    ``pos`` (``seq[:, pos]`` the token fed there): None before ``cfg``'s
    local ring is full, else (the JAX full-sequence forward's logits at
    ``pos``, the cache of the JAX prefill over ``seq[:, :pos + 1]`` from
    ``fresh()``: the layers after a local one see the forward's hidden
    states)."""
    window = local_window(cfg)
    if not window or seq.shape[1] <= window:
        return lambda pos: None
    fwd, _ = jt.model_apply(params, cfg, {"tokens": jnp.asarray(seq)})
    prefill = jlm.make_prefill(cfg)

    def at(pos):
        if pos < window:
            return None
        _, cache = prefill(params, {"tokens": jnp.asarray(seq[:, :pos + 1])},
                           fresh())
        return fwd[:, pos], cache

    return at


def assert_greedy(tokens, logits, tol):
    """``tokens`` (B,) equal the argmax of ``logits`` (B, vocab) in every
    row whose top-2 margin exceeds 2 ``tol`` of max|logit|: there any
    logits within ``tol`` of max|logit| of these have the same argmax."""
    want = np.asarray(logits, np.float32)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol * np.abs(want).max()
    assert clear.any()
    np.testing.assert_array_equal(np.asarray(tokens)[clear],
                                  want.argmax(-1)[clear])


def _serve_steps(arch, prompt, n_steps, dtype):
    """Prefill ``prompt`` then decode ``n_steps`` seeded tokens in both
    packages; yields (what, port logits, jax logits, port cache, jax
    cache) after each step, the port's cache (updated in place) as a
    numpy copy.  A decode step at a position at or past a local layer's
    window finds that layer's ring full, where the reference's decode
    attends one position more than its forward: from there on the jax
    logits are the JAX full-sequence forward's at that position and the
    jax cache the JAX prefill's over the tokens so far (the layers after
    a local one see the forward's hidden states)."""
    jc, tc = _cfgs(arch)
    max_len = 24
    params = _jax_params(arch)

    def fresh():
        c = jt.init_cache(jc, 2, max_len)
        return _f32(c) if dtype == "float32" else c

    jcache = fresh()
    if dtype == "float32":
        params = _f32(params)
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
    past = jax_past_the_window(
        jc, params, np.concatenate([toks] + list(feed), axis=1), fresh)
    for t in range(n_steps):
        pos = prompt + t
        tn, tl, tcache = tlm.make_decode_step(tc)(
            tp, tcache, pos, torch.from_numpy(feed[t]))
        assert tn.dtype == torch.int32
        ref = past(pos)
        if ref is not None:
            jl, jcache = ref
            if dtype == "float32":
                assert_greedy(tn.numpy(), jl, 1e-4)
            yield (f"decode {t} (JAX forward)", tl, jl,
                   convert.tree_to_numpy(tcache), jcache)
            continue
        jn, jl, jcache = jlm.make_decode_step(jc)(
            params, jcache, jnp.int32(pos), jnp.asarray(feed[t]))
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


@pytest.mark.parametrize("max_len", [12, 40])
def test_local_decode_attends_the_forward_window(max_len):
    """A local layer (window 16) decoded token by token equals its
    full-sequence forward at every position, in f32: with a cache shorter
    than the window (12 slots) and with a ring of window + 1 = 17 slots
    that wraps (40 tokens), where the full ring's oldest slot is masked."""
    from repro_torch.models import attention

    _, tc = _cfgs("gemma2_2b")
    lspec = tc.period[0]
    assert lspec.mixer == "local" and lspec.window == 16
    gen = torch.Generator().manual_seed(3)
    p = jax.tree.map(lambda t: t.float(),
                     attention.attn_init(gen, tc, lspec))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, max_len, tc.d_model)).astype(np.float32))
    fwd = attention.attn_apply(p, tc, lspec, x,
                               positions=torch.arange(max_len))
    cache = attention.attn_cache_init(tc, lspec, 2, max_len,
                                      dtype=torch.float32, device=CPU)
    assert cache["k"].shape[1] == min(max_len, 17)
    for t in range(max_len):
        y = attention.attn_apply(p, tc, lspec, x[:, t:t + 1],
                                 positions=torch.tensor([t]), cache=cache,
                                 cache_len=t, mode="decode")
        assert _rel(y[:, 0], fwd[:, t]) < 1e-5, t


def test_decode_continues_from_a_carried_jax_cache():
    """The cache carry: the JAX prefill's cache, carried into the port,
    decodes, its local ring being full (position 20 of a window of 16),
    to the logits of the JAX full-sequence forward at that position and
    the cache of the JAX prefill over the 21 tokens."""
    jc, tc = _cfgs("gemma2_2b")
    params = _f32(_jax_params("gemma2_2b"))
    toks = _tokens(9, (2, 20), jc.vocab)
    _, jcache = jlm.make_prefill(jc)(params, {"tokens": jnp.asarray(toks)},
                                     _f32(jt.init_cache(jc, 2, 24)))
    tcache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), tc,
                                      device=CPU)
    last = _tokens(10, (2, 1), jc.vocab)
    tn, tl, tcache = tlm.make_decode_step(tc)(_port(params, tc), tcache,
                                              20, torch.from_numpy(last))
    jl, jcache = jax_past_the_window(
        jc, params, np.concatenate([toks, last], axis=1),
        lambda: _f32(jt.init_cache(jc, 2, 24)))(20)
    assert _rel(tl, jl) < 1e-4
    assert_greedy(tn.numpy(), jl, 1e-4)
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
# what the model does not know
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("field", ["mixer", "ffn"])
def test_unknown_layer_kind_raises(field):
    _, tc = _cfgs("qwen2_0_5b")
    cfg = tc.with_(period=(dataclasses.replace(tc.period[0],
                                               **{field: "conv"}),))
    for build in (lambda: tt.model_init(0, cfg, device=CPU),
                  lambda: tt.init_cache(cfg, 1, 8, device=CPU)):
        with pytest.raises(ValueError, match="unknown layer kind 'conv'"):
            build()


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
