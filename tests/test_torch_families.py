"""The port's remaining families end to end against the JAX reference, on
the CPU: reduced ``llama4_scout_17b_a16e`` (MoE, top-1, a shared expert),
``deepseek_v2_lite_16b`` (MLA, the dense first layer ``prefix``, MoE
top-2 with two shared experts, per-row dispatch), ``llama_3_2_vision_11b``
(a cross-attention layer every 5th, 8 image tokens) and ``hubert_xlarge``
(frame embeddings in, non-causal, an untied head, no decode).

Parameters come from the JAX ``model_init`` through the weight carry;
tokens, frames and image embeddings (× 0.02, as ``tests/test_models.py``)
from numpy with a seed.  Tolerances are ``tests/test_torch_models.py``'s:
f32 logits within 1e-4 of max|logit| and f32 caches within 1e-5; the bf16
loss within 5e-3; bf16 logits within 2e-2 of max|logit|;
bf16 caches within two bf16 ulps; ``DecodeExecutor`` tokens exactly equal
at f32.  Those bf16 tolerances were set on models of 2–4 layers; the
reduced VLM has ten (two periods of five), whose bf16 drift puts a decode
step's logits 2.1e-2 of max|logit| apart and single K/V elements ~3 ulps,
so its bf16 prefill and decode are held to them one period deep (five
layers, the cross layer among them); all ten run at f32, and at bf16
against the JAX f32 run, no further off it than JAX's own bf16 run.

Two settings, each with its reason:

- at f32 the MoE runs with ``moe_bf16_dispatch=False``: llama4's knob
  rounds the expert products to bf16, which puts ~7e-4 of max|logit|
  between two f32 forwards that differ by f32 rounding; the knob itself
  is held by ``tests/test_torch_moe.py`` and by the bf16 cases here;
- prefill and decode run the MoE at ``capacity_factor = n_experts``, as
  the reference's own test does (``tests/test_models.py:97-99``): a decode
  step routes 2 tokens, so at the config's factor GShard capacity would
  drop tokens the forward keeps.
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

from test_torch_models import _caches_close, _f32, _rel, _tokens


LLAMA4, DEEPSEEK, VISION, HUBERT = (
    "llama4_scout_17b_a16e", "deepseek_v2_lite_16b", "llama_3_2_vision_11b",
    "hubert_xlarge")
FAMILIES = (LLAMA4, DEEPSEEK, VISION, HUBERT)
DECODERS = (LLAMA4, DEEPSEEK, VISION)
IMPLS = ("naive", "xla_chunked", "pallas")
CPU = torch.device("cpu")
DRIFT_RATIO = 1.25      # bf16 RMS error vs the JAX bf16 run's, both off f32


def _cfgs(arch, *, f32=False, serve=False, **kw):
    out = []
    for get in (jconfigs.get_reduced, tconfigs.get_reduced):
        cfg = get(arch).with_(**kw)
        if cfg.moe is not None and f32:
            cfg = cfg.with_(moe_bf16_dispatch=False)
        if cfg.moe is not None and serve:
            cfg = cfg.with_(moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, n_layers=None):
    jc, _ = _cfgs(arch)
    if n_layers:
        jc = jc.with_(n_layers=n_layers)
    params, _ = jt.model_init(jax.random.PRNGKey(0), jc)
    return params


def _port(tree, tc):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), tc,
                                     device=CPU)


def _batch(cfg, seed, B, S, dtype):
    """(jax batch, port batch): tokens, or HuBERT's frames, plus the VLM's
    image embeddings, in ``dtype``; the port's a bit-equal copy."""
    rng = np.random.default_rng(seed)
    jb = {}
    if cfg.audio_frontend:
        jb["frames"] = jnp.asarray(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32) * 0.02).astype(dtype)
    else:
        jb["tokens"] = jnp.asarray(_tokens(seed, (B, S), cfg.vocab))
    if cfg.n_img_tokens:
        jb["image_embeds"] = jnp.asarray(rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
            * 0.02).astype(dtype)
    tb = convert.tree_from_numpy({k: np.asarray(v) for k, v in jb.items()},
                                 device=CPU)
    return jb, tb


# ---------------------------------------------------------------------------
# the full-sequence forward and the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_logits_match_jax_at_f32(arch, impl):
    """S = 40: ragged against the 16-wide chunks."""
    jc, tc = _cfgs(arch, f32=True, attention_impl=impl)
    params = _f32(_jax_params(arch))
    jb, tb = _batch(jc, 1, 2, 40, jnp.float32)
    want, _ = jt.model_apply(params, jc, jb)
    before = flash_attention.launches
    got, cache = tt.model_apply(_port(params, tc), tc, tb)
    assert flash_attention.launches == before      # the CPU runs no kernel
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (2, 40, jc.vocab)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("loss_chunk", [0, 16])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_jax_at_bf16(arch, loss_chunk):
    """bf16 weights and inputs as ``model_init`` and the tests make them,
    the configs' own knobs (llama4's bf16 dispatch included), on the
    kernel path's switch; ``loss_chunk`` 16 takes the chunked path."""
    jc, tc = _cfgs(arch, attention_impl="pallas", loss_chunk=loss_chunk)
    params = _jax_params(arch)
    jb, tb = _batch(jc, 2, 2, 40, jnp.bfloat16)
    labels = _tokens(3, (2, 40), jc.vocab)
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels)
    want = float(jlm.loss_fn(params, jc, jb))
    got = tlm.loss_fn(_port(params, tc), tc, tb)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) < 5e-3


@pytest.mark.parametrize("arch", FAMILIES)
def test_count_params_equals_reference(arch):
    """The carried tree and the port's own ``model_init`` have the
    reference's leaves, shapes and dtypes: ``prefix`` for deepseek, no
    ``embed`` and an untied ``head`` for HuBERT."""
    jc, tc = _cfgs(arch)
    params = _jax_params(arch)
    assert tt.count_params(_port(params, tc)) == jt.count_params(params)
    own = tt.model_init(0, tc, device=CPU)
    assert tt.count_params(own) == jt.count_params(params)
    same = jax.tree.map(lambda a: (a.shape, str(a.dtype)), params)
    mine = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]),
                        own)
    assert jax.tree.leaves(mine) == jax.tree.leaves(same)
    assert ("prefix" in own) == (arch == DEEPSEEK)
    assert ("embed" in own) == (arch != HUBERT)
    assert ("head" in own) == (arch == HUBERT)


def test_prefix_is_checked_by_the_carry():
    """A deepseek tree without its dense first layer, or a tree with one
    for a config without it, is refused."""
    jc, tc = _cfgs(DEEPSEEK)
    tree = jax.tree.map(np.asarray, _jax_params(DEEPSEEK))
    headless = {k: v for k, v in tree.items() if k != "prefix"}
    with pytest.raises(ValueError, match="prefix"):
        convert.params_from_numpy(headless, tc, device=CPU)
    with pytest.raises(ValueError, match="prefix"):
        convert.params_from_numpy(tree, tc.with_(first_layer_ffn=0),
                                  device=CPU)
    cache = jax.tree.map(np.asarray, jt.init_cache(jc, 1, 8))
    convert.cache_from_numpy(cache, tc, device=CPU)
    with pytest.raises(ValueError, match="prefix"):
        convert.cache_from_numpy(dict(cache, prefix={}), tc, device=CPU)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _serve_steps(arch, prompt, n_steps, dtype, n_layers=None):
    """Prefill ``prompt`` tokens (with the VLM's image embeddings) then
    decode ``n_steps`` seeded tokens in both packages; yields (what, port
    logits, jax logits, port cache, jax cache) after each step, the port's
    cache (updated in place) as a numpy copy.  The VLM runs one period
    deep at bf16 unless ``n_layers`` says otherwise."""
    f32 = dtype == "float32"
    if n_layers is None and not f32 and arch == VISION:
        n_layers = 5
    jc, tc = _cfgs(arch, f32=f32, serve=True,
                   **({"n_layers": n_layers} if n_layers else {}))
    max_len = 24
    params = _jax_params(arch, n_layers)
    jcache = jt.init_cache(jc, 2, max_len)
    if f32:
        params, jcache = _f32(params), _f32(jcache)
    tp = _port(params, tc)
    tcache = tt.init_cache(tc, 2, max_len, dtype=getattr(torch, dtype),
                           device=CPU)
    jb, tb = _batch(jc, 5, 2, prompt, getattr(jnp, dtype))
    jl, jcache = jlm.make_prefill(jc)(params, jb, jcache)
    tl, tcache = tlm.make_prefill(tc)(tp, tb, tcache)
    yield "prefill", tl, jl, convert.tree_to_numpy(tcache), jcache
    feed = _tokens(6, (n_steps, 2, 1), jc.vocab)
    for t in range(n_steps):
        pos = prompt + t
        tn, tl, tcache = tlm.make_decode_step(tc)(
            tp, tcache, pos, torch.from_numpy(feed[t]))
        jn, jl, jcache = jlm.make_decode_step(jc)(
            params, jcache, jnp.int32(pos), jnp.asarray(feed[t]))
        assert tn.dtype == torch.int32
        if f32:
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        yield f"decode {t}", tl, jl, convert.tree_to_numpy(tcache), jcache


def _cross_caches(cache, cfg):
    return [cache["stack"][j]["mixer"] for j, s in enumerate(cfg.period)
            if s.cross_attn]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Every cache tensor after every step: llama4's K/V, deepseek's MLA
    latents with its ``prefix`` block's, the VLM's self-attention K/V and
    its cross layers' image K/V, which decode leaves as prefill wrote
    them."""
    steps = list(_serve_steps(arch, 12, 4, dtype))
    assert len(steps) == 5
    for what, tl, jl, tcache, jcache in steps:
        if dtype == "float32":
            assert _rel(tl, jl) < 1e-4, what
            _caches_close(tcache, jcache, atol=1e-5, rtol=1e-5)
        else:
            assert _rel(tl, jl) < 2e-2, what
            _caches_close(tcache, jcache, atol=2 * 2 ** -5, rtol=2 * 2 ** -8)
    tc = tconfigs.get_reduced(arch)
    if arch == DEEPSEEK:
        assert set(steps[-1][3]["prefix"]["mixer"]) == {"c", "kr"}
    if arch == VISION:
        first, last = (_cross_caches(s[3], tc) for s in (steps[0], steps[-1]))
        assert first and all(a[k].any() for a in first for k in ("k", "v"))
        for a, b in zip(first, last):
            for k in ("k", "v"):
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].shape[2] == tc.n_img_tokens


def _rms(d):
    return float(np.sqrt(np.mean(np.square(d))))


def test_vision_bf16_full_depth_drifts_as_the_reference():
    """The reduced VLM's ten layers at bf16, the second period's cross
    layer and caches included.  Pointwise, two bf16 runs of ten layers sit
    up to ~2.5e-2 of max|logit| apart, past the 2e-2 that
    :func:`test_prefill_and_decode_match_jax` holds at five; so each run is
    held to the JAX f32 run on the same weights instead: over every step's
    logits, and over each cache tensor after the last step, the port's
    bf16 RMS error is at most DRIFT_RATIO times the JAX bf16 run's (each
    measured within 0.94-1.06 of it).  The cross layers' image K/V, a
    projection of the input with no depth behind it, stay within two bf16
    ulps of JAX's and unchanged by decode."""
    full = _cfgs(VISION)[1].n_layers
    bf16 = list(_serve_steps(VISION, 12, 4, "bfloat16", n_layers=full))
    f32 = list(_serve_steps(VISION, 12, 4, "float32", n_layers=full))
    assert len(bf16) == len(f32) == 5

    def flat(i, steps):
        return np.concatenate([np.asarray(s[i], np.float32).ravel()
                               for s in steps])

    truth = flat(2, f32)
    ours, theirs = _rms(flat(1, bf16) - truth), _rms(flat(2, bf16) - truth)
    assert ours <= DRIFT_RATIO * theirs, (ours, theirs)
    tc = tconfigs.get_reduced(VISION)
    last = [jax.tree.map(lambda a: np.asarray(a, np.float32), c)
            for c in (bf16[-1][3], bf16[-1][4], f32[-1][4])]
    for got, want, exact in zip(*map(jax.tree.leaves, last)):
        assert got.shape == exact.shape
        assert _rms(got - exact) <= DRIFT_RATIO * _rms(want - exact)
    first = _cross_caches(bf16[0][3], tc)
    assert sum(a["k"].shape[0] for a in first) == 2     # stacked periods
    for a, b, w in zip(first, _cross_caches(bf16[-1][3], tc),
                       _cross_caches(bf16[-1][4], tc)):
        for k in ("k", "v"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_allclose(b[k], np.asarray(w[k], np.float32),
                                       atol=2 * 2 ** -5, rtol=2 * 2 ** -8)


@pytest.mark.parametrize("arch", [LLAMA4, DEEPSEEK])
def test_decode_executor_tokens_match_jax(arch, monkeypatch):
    """Three requests of different prompt lengths and token counts through
    both executors at the config's own capacity factor (decode steps drop
    what GShard drops, in both), at f32 parameters and f32 caches."""
    jc, tc = _cfgs(arch, f32=True)
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


def test_decode_takes_extra_batch_entries():
    """``make_decode_step``'s ``extra`` reaches the model as the
    reference's does: image embeddings given to a decode step change
    nothing, its cross layers reading the prefill's cache."""
    _, tc = _cfgs(VISION, f32=True)
    tp = _port(_f32(_jax_params(VISION)), tc)
    _, tb = _batch(tc, 8, 2, 6, jnp.float32)
    outs = []
    for extra in (None, {"image_embeds": tb["image_embeds"] * 3}):
        cache = tt.init_cache(tc, 2, 8, dtype=torch.float32, device=CPU)
        tlm.make_prefill(tc)(tp, tb, cache)
        outs.append(tlm.make_decode_step(tc)(
            tp, cache, 6, tb["tokens"][:, :1], extra)[1])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
