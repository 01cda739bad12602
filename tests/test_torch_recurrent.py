"""The port's recurrent families against the JAX reference, on the CPU.

Reduced ``rwkv6_3b`` (2 layers of RWKV-6 time-mix and channel-mix, 4
heads of 16) and ``recurrentgemma_2b`` (2 periods of rglru, rglru, local
attention with window 16).  Parameters come from the JAX ``model_init``
through the weight carry (``repro_torch.models.convert``); tokens from
numpy with a seed.  On CPU tensors the mixers' scans run the plain
versions (``rwkv6_scan_plain``: the chunked form; ``rglru_scan_plain``),
where the reference runs a ``lax.scan`` and an ``associative_scan``.
Tolerances, each with its reason:

- f32 parameters (both trees cast), where the algorithm is the point:
  logits within 1e-4 of max|logit| (other summation orders; ~1e-6 is
  measured), the port's own f32-cache decode within 1e-4 of its own f32
  forward.
- f32 decode against the reference: the reference rounds the cached
  token-shift input ``x_prev`` to bf16 always (``recurrent.py:206, 243``)
  and the RG-LRU conv history to bf16 at prefill but not at decode
  (``:83-84, 97``).  The port writes each cache tensor in its own dtype
  (``x_prev`` and ``conv`` in the cache's), so with the reference's cache
  dtypes an f32 input that differs in its last bit can round to the next
  bf16 (2^-8 relative) on one side only: decode-step logits within 1e-3
  of max|logit| (~1.5e-4 measured), the prefill's within 1e-4, each cache
  tensor within 4e-3 of its max|value| (one bf16 rounding; ~3e-3
  measured).
- bf16 parameters, the real dtype: the loss within 5e-3, the bound of
  ``tests/test_models.py:164-165``; logits and each cache tensor within
  3e-2 of their max|value| (bf16 rounds at other places in the two
  frameworks and the recurrent states carry it forward; ~2e-2 measured).
- A decode step that finds a local layer's ring full attends the
  forward's window, where the reference's decode attends every ring slot,
  window + 1 positions: there the port's decode logits are held to the
  JAX full-sequence forward (f32: 1e-4 of max|logit|, the forward holds
  no bf16 cache rounding) and its caches to the JAX prefill's over the
  tokens so far (the layers after the local one see the forward's hidden
  states).
- ``DecodeExecutor`` tokens exactly equal at f32 parameters.
"""
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
from repro_torch.kernels.linear_scan import (rglru_scan, rglru_scan_plain,
                                             rwkv6_scan, rwkv6_scan_plain)
from repro_torch.launch.serve import DecodeExecutor
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models import recurrent
from repro_torch.models import transformer as tt
from test_torch_models import assert_greedy, jax_past_the_window

RECURRENT = ("rwkv6_3b", "recurrentgemma_2b")
CPU = torch.device("cpu")


def _cfgs(arch, **kw):
    return (jconfigs.get_reduced(arch).with_(**kw),
            tconfigs.get_reduced(arch).with_(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed=0):
    """The reference's ``model_init``; for RG-LRU layers ``lam`` redrawn
    from U(-8, -4).  ``model_init`` draws it from U(2.2, 7.0), which gives
    a = exp(-8·r·softplus(lam)) ≈ 1e-8: the recurrence would carry almost
    nothing from step to step and a broken state hand-off would not show.
    U(-8, -4) gives a in ~(0.9, 0.999), the range the reference's init
    comment names."""
    jc, _ = _cfgs(arch)
    params, _ = jt.model_init(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        if jax.tree_util.keystr(path).endswith("['lam']"):
            return jnp.asarray(rng.uniform(-8.0, -4.0, a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, params)


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


def _leaves(cache):
    """(path, numpy f32 array) of every cache leaf, in the reference's
    leaf order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda a: np.asarray(a, np.float32), cache))
    return [(jax.tree_util.keystr(p), a) for p, a in flat]


def _dtypes(cache):
    flat, _ = jax.tree_util.tree_flatten_with_path(cache)
    return [(jax.tree_util.keystr(p), str(a.dtype).replace("torch.", ""))
            for p, a in flat]


def _caches_close(tcache, jcache, tol, what):
    """Every cache leaf within ``tol`` of its own max|value| (the logits'
    criterion, a leaf at a time)."""
    got, want = _leaves(tcache), _leaves(jcache)
    assert [p for p, _ in got] == [p for p, _ in want] and got
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        assert _rel(g, w) < tol, (what, path, _rel(g, w))


# ---------------------------------------------------------------------------
# the full-sequence forward and the loss
# ---------------------------------------------------------------------------
TRAIN_CASES = [("rwkv6_3b", "xla_chunked"), ("recurrentgemma_2b", "naive"),
               ("recurrentgemma_2b", "xla_chunked"),
               ("recurrentgemma_2b", "pallas")]


@pytest.mark.parametrize("arch,impl", TRAIN_CASES)
def test_train_logits_match_jax_at_f32(arch, impl):
    """S = 40: past the reduced window of 16, and ragged against the
    rwkv6 plain scan's 64-token chunk (one padded chunk)."""
    jc, tc = _cfgs(arch, attention_impl=impl)
    params = _f32(_jax_params(arch))
    toks = _tokens(1, (2, 40), jc.vocab)
    want, _ = jt.model_apply(params, jc, {"tokens": jnp.asarray(toks)})
    before = (rwkv6_scan.launches, rglru_scan.launches)
    got, cache = tt.model_apply(_port(params, tc), tc,
                                {"tokens": torch.from_numpy(toks)})
    assert (rwkv6_scan.launches, rglru_scan.launches) == before
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (2, 40, jc.vocab)
    assert _rel(got, want) < 1e-4


LOSS_CASES = [("rwkv6_3b", "xla_chunked"), ("recurrentgemma_2b", "pallas"),
              ("recurrentgemma_2b", "xla_chunked")]


@pytest.mark.parametrize("loss_chunk", [0, 16])
@pytest.mark.parametrize("arch,impl", LOSS_CASES)
def test_loss_matches_jax_at_bf16(arch, impl, loss_chunk):
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


@pytest.mark.parametrize("arch", RECURRENT)
def test_count_params_and_layout_equal_reference(arch):
    jc, tc = _cfgs(arch)
    params = _jax_params(arch)
    assert tt.count_params(_port(params, tc)) == jt.count_params(params)
    own = tt.model_init(0, tc, device=CPU)
    assert tt.count_params(own) == jt.count_params(params)
    same = jax.tree.map(lambda a: (a.shape, str(a.dtype)), params)
    mine = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]),
                        own)
    assert jax.tree.structure(mine) == jax.tree.structure(same)
    assert jax.tree.leaves(mine) == jax.tree.leaves(same)


@pytest.mark.parametrize("arch", RECURRENT)
def test_weight_carry_keeps_layer_order(arch):
    """The reduced configs stack two full periods on axis 0 (rwkv6: a
    period of one layer; recurrentgemma: rglru, rglru, local).  Swapping
    the two stacked layers of the first slot in the carried tree changes
    the logits: the order is read, not ignored."""
    jc, tc = _cfgs(arch)
    assert (tc.n_full_periods, tc.n_remainder) == (2, 0)
    params = _f32(_jax_params(arch))
    toks = _tokens(4, (1, 24), jc.vocab)
    want, _ = jt.model_apply(params, jc, {"tokens": jnp.asarray(toks)})
    tp = _port(params, tc)
    got, _ = tt.model_apply(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) < 1e-4
    mixer = tp["stack"][0]["mixer"]
    name = "w_k" if arch == "rwkv6_3b" else "in_x"
    mixer[name]["w"] = mixer[name]["w"][[1, 0]]
    swapped, _ = tt.model_apply(tp, tc, {"tokens": torch.from_numpy(toks)})
    assert _rel(swapped, want) > 1e-3
    with pytest.raises(ValueError):
        convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                  tc.with_(n_layers=tc.n_layers + 1),
                                  device=CPU)


def test_mixers_reach_the_scans_through_the_seam(monkeypatch):
    """The path choice: rwkv6 runs its recurrence through the rwkv6 scan in
    train, prefill and decode mode (S = 1 at decode); rglru through the
    rglru scan in train and prefill mode only (decode keeps the one-step
    formula)."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, a[0].shape[1]))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setitem(recurrent.SCANS, "rwkv6",
                        spy("rwkv6", rwkv6_scan_plain))
    monkeypatch.setitem(recurrent.SCANS, "rglru",
                        spy("rglru", rglru_scan_plain))
    for arch, name in (("rwkv6_3b", "rwkv6"), ("recurrentgemma_2b", "rglru")):
        _, tc = _cfgs(arch)
        n = sum(s.mixer == name for s in tc.period) * tc.n_layers \
            // len(tc.period)
        params = tt.model_init(0, tc, device=CPU)
        toks = torch.from_numpy(_tokens(3, (2, 10), tc.vocab))
        calls.clear()
        tt.model_apply(params, tc, {"tokens": toks})
        assert calls == [(name, 10)] * n
        cache = tt.init_cache(tc, 2, 16, device=CPU)
        calls.clear()
        tlm.make_prefill(tc)(params, {"tokens": toks}, cache)
        assert calls == [(name, 10)] * n
        calls.clear()
        tlm.make_decode_step(tc)(params, cache, 10, toks[:, :1])
        assert calls == ([(name, 1)] * n if name == "rwkv6" else [])


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
FORWARD = "(JAX forward) "      # a step held to the JAX forward


def _serve_steps(arch, prompt, n_steps, dtype, *, cache0=None):
    """Prefill ``prompt`` then decode ``n_steps`` seeded tokens in both
    packages; yields (what, port logits, jax logits, port cache, jax
    cache) after each step, the port's cache (updated in place) as a
    numpy copy.  At f32 the reference's cache is its own for rwkv6 (a
    bf16 ``x_prev``, an f32 state) and cast to f32 for recurrentgemma
    (its K/V cache refuses f32 K/V); the port's cache has the same dtypes
    leaf for leaf.  ``cache0`` (a function of the JAX cache) sets the
    cache both prefills start from.  A decode step at a position at or
    past the local window finds the ring full: from there on the jax
    logits are the JAX full-sequence forward's at that position and the
    jax cache the JAX prefill's over the tokens so far (``what`` says
    so)."""
    jc, tc = _cfgs(arch)
    max_len = 24
    params = _jax_params(arch)
    tdtype = torch.bfloat16
    if dtype == "float32":
        params = _f32(params)
        if arch == "recurrentgemma_2b":
            tdtype = torch.float32

    def fresh():
        c = jt.init_cache(jc, 2, max_len)
        return _f32(c) if tdtype == torch.float32 else c

    jcache = fresh()
    if cache0 is not None:
        jcache = cache0(jcache)
    tp = _port(params, tc)
    tcache = tt.init_cache(tc, 2, max_len, dtype=tdtype, device=CPU)
    assert _dtypes(tcache) == _dtypes(jcache)
    if cache0 is not None:
        tcache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                          tc, device=CPU)
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
            yield (f"{FORWARD}decode {t}", tl, jl,
                   convert.tree_to_numpy(tcache), jcache)
            continue
        _, jl, jcache = jlm.make_decode_step(jc)(
            params, jcache, jnp.int32(pos), jnp.asarray(feed[t]))
        yield f"decode {t}", tl, jl, convert.tree_to_numpy(tcache), jcache


# (arch, prompt): recurrentgemma's local cache holds window + 1 = 17
# slots, so a 20-token prompt wraps the ring at prefill and every decode
# step finds it full
SERVE_CASES = [("rwkv6_3b", 12), ("recurrentgemma_2b", 12),
               ("recurrentgemma_2b", 20)]


@pytest.mark.parametrize("arch,prompt", SERVE_CASES)
def test_prefill_and_decode_match_jax_at_bf16(arch, prompt):
    steps = list(_serve_steps(arch, prompt, 4, "bfloat16"))
    assert len(steps) == 5
    for what, tl, jl, tcache, jcache in steps:
        assert _rel(tl, jl) < 3e-2, what
        _caches_close(tcache, jcache, 3e-2, what)
    names = {p for p, _ in _leaves(steps[-1][3])}
    want = ({"['stack'][0]['ffn']['x_prev']", "['stack'][0]['mixer']['state']",
             "['stack'][0]['mixer']['x_prev']"} if arch == "rwkv6_3b" else
            {f"['stack'][{j}]['mixer']['{n}']" for j in (0, 1)
             for n in ("conv", "h")}
            | {"['stack'][2]['mixer']['k']", "['stack'][2]['mixer']['v']"})
    assert names == want


@pytest.mark.parametrize("arch,prompt", SERVE_CASES)
def test_prefill_and_decode_match_jax_at_f32(arch, prompt):
    for what, tl, jl, tcache, jcache in _serve_steps(arch, prompt, 4,
                                                     "float32"):
        tol = 1e-3 if what.startswith("decode") else 1e-4
        assert _rel(tl, jl) < tol, what
        _caches_close(tcache, jcache, 4e-3, what)


def test_prefill_reads_the_state_but_not_h():
    """A prefill continues from a nonzero cache as the reference's does:
    RWKV-6 from ``cache["state"]`` and ``x_prev``, RG-LRU from zeros
    whatever ``cache["h"]`` holds (but from the cached conv history)."""
    def seeded(c):
        rng = np.random.default_rng(12)
        return jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape), a.dtype), c)

    for arch in RECURRENT:
        steps = list(_serve_steps(arch, 12, 1, "float32", cache0=seeded))
        for what, tl, jl, _, _ in steps:
            assert _rel(tl, jl) < (1e-4 if what == "prefill" else 1e-3), \
                (arch, what)


@pytest.mark.parametrize("arch", RECURRENT)
def test_f32_cache_decode_matches_own_forward(arch):
    """The port's state hand-off from prefill to decode: with f32 weights
    and an f32 cache, every step's logits within 1e-4 of max|logit| of the
    port's f32 full-sequence forward over the prompt and the fed tokens.
    RecurrentGemma's steps run at positions 9-20, across its reduced
    window of 16: from position 16 on its local ring is full and the step
    attends the forward's window."""
    _, tc = _cfgs(arch)
    tp = _port(_f32(_jax_params(arch)), tc)
    prompt, n = (20, 6) if arch == "rwkv6_3b" else (9, 12)
    toks = torch.from_numpy(_tokens(7, (2, prompt + n), tc.vocab))
    fwd, _ = tt.model_apply(tp, tc, {"tokens": toks})
    cache = tt.init_cache(tc, 2, prompt + n, dtype=torch.float32, device=CPU)
    logits, cache = tlm.make_prefill(tc)(tp, {"tokens": toks[:, :prompt]},
                                         cache)
    assert _rel(logits, fwd[:, prompt - 1]) < 1e-4
    for t in range(n):
        _, logits, cache = tlm.make_decode_step(tc)(
            tp, cache, prompt + t, toks[:, prompt + t:prompt + t + 1])
        assert _rel(logits, fwd[:, prompt + t]) < 1e-4, t


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_executor_tokens_match_jax(arch, monkeypatch):
    """Three requests of different prompt lengths (left-padded with token
    0: the recurrent state absorbs the padding, in both) and token counts
    through both executors at f32 parameters, each cache with the
    reference's dtypes (recurrentgemma's JAX cache cast to f32 for its
    K/V, the port's f32; rwkv6's the reference's own, bf16 x_prev)."""
    jc, tc = _cfgs(arch)
    params = _f32(_jax_params(arch))
    cache_dtype = torch.bfloat16
    if arch == "recurrentgemma_2b":
        make_cache = jt.init_cache
        monkeypatch.setattr(jserve.transformer, "init_cache",
                            lambda *a: _f32(make_cache(*a)))
        cache_dtype = torch.float32
    jex = jserve.DecodeExecutor(jc, max_batch=4, max_len=32, seed=0)
    jex.params = params
    tex = DecodeExecutor(tc, max_batch=4, max_len=32, device=CPU,
                         params=_port(params, tc), cache_dtype=cache_dtype)
    rng = np.random.default_rng(7)
    reqs = [{"prompt": rng.integers(1, jc.vocab, n).astype(np.int32),
             "n_tokens": g} for n, g in ((9, 5), (14, 3), (4, 6))]
    want = jex(reqs)
    got = tex(reqs)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert tex.device_steps == jex.device_steps == 7


# ---------------------------------------------------------------------------
# On the card: the kernel path against the plain path
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 logits compared
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", RECURRENT)
def test_cuda_kernel_path_matches_plain_path(cuda, arch, monkeypatch):
    """At f32 weights (the drawn bf16 ones upcast): the forward through
    the kernels within 1e-4 of max|logit| of the forward through the plain
    scans (the seam pointed at them)."""
    _, tc = _cfgs(arch, attention_impl="pallas")
    params = jax.tree.map(lambda t: t.float(),
                          tt.model_init(0, tc, device=cuda))
    toks = torch.from_numpy(_tokens(8, (2, 40), tc.vocab)).to(cuda)
    before = rwkv6_scan.launches + rglru_scan.launches
    got, _ = tt.model_apply(params, tc, {"tokens": toks})
    n = sum(s.mixer in ("rwkv6", "rglru") for s in tc.period) \
        * tc.n_layers // len(tc.period)
    assert rwkv6_scan.launches + rglru_scan.launches == before + n
    monkeypatch.setitem(recurrent.SCANS, "rwkv6", rwkv6_scan_plain)
    monkeypatch.setitem(recurrent.SCANS, "rglru", rglru_scan_plain)
    want, _ = tt.model_apply(params, tc, {"tokens": toks})
    assert _rel(got.cpu(), want.cpu()) < 1e-4
