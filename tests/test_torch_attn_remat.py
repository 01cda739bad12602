"""``attn_remat`` in the port's blockwise attention, on the CPU.

The reference wraps each chunk-pair step of its attention scan in
``jax.checkpoint`` when ``cfg.attn_remat`` is set
(``src/repro/models/attention.py``); the port runs each pair under
``torch.utils.checkpoint(..., use_reentrant=False)``.  The recomputed
pair is the same computation in the same order, so:

- ``blockwise_attention`` with the flag on equals the flag off bit for
  bit, the output and the gradients of q, k and v, on every masking case
  (causal, a window, softcap 50, ``kv_len`` short of Skv, lengths that
  do not divide the chunks, MLA's hd_v != hd, non-causal), at f32 and
  bf16; at f32 the flag on is also held to the reference's
  ``blockwise_attention(attn_remat=True)`` and its ``jax.vjp`` within
  ``tests/test_torch_flash_attention.py``'s 2e-5 of max|value|;
- the bytes autograd saves for the backward fall, on a Qwen2-0.5B
  attention layer at S = 2,048, by at least the chunk pairs' f32 scores;
- without a gradient no checkpoint is entered and nothing changes.

The model-level check (the loss and every gradient bit-equal with
``attn_remat`` and the period ``remat`` on and off, for the reduced
Qwen2, Gemma2, RecurrentGemma, deepseek and HuBERT) is the parametrised
``test_remat_changes_no_bit`` of ``tests/test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as tt
from repro_torch.models.attention import attn_apply, attn_init
from repro_torch.models.attention import blockwise_attention

F32_TOL = 2e-5          # tests/test_torch_flash_attention.py's f32 tolerance

# name: (B, Sq, Skv, H, K, hd, hd_v, causal, window, cap, kv_len, q_chunk,
#        kv_chunk)
CASES = {
    "causal": (2, 64, 64, 4, 2, 16, 16, True, 0, 0.0, None, 16, 32),
    "window": (2, 64, 64, 4, 2, 16, 16, True, 24, 0.0, None, 16, 16),
    "softcap": (2, 64, 64, 4, 2, 16, 16, True, 0, 50.0, None, 16, 16),
    "kv_len": (2, 64, 64, 4, 2, 16, 16, True, 0, 0.0, 40, 16, 16),
    "ragged": (2, 50, 50, 4, 2, 16, 16, True, 0, 0.0, None, 16, 32),
    "mla": (2, 48, 48, 4, 4, 24, 16, True, 0, 0.0, None, 16, 16),
    "non_causal": (2, 40, 40, 4, 4, 20, 20, False, 0, 0.0, None, 16, 16),
}


def _inputs(case, dtype, seed=0):
    B, Sq, Skv, H, K, hd, hd_v = CASES[case][:7]
    rng = np.random.default_rng(seed)
    # scores of a few units, so softcap 50 and the masks both bite
    arrs = [rng.standard_normal(s).astype(np.float32) * 2.0
            for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd_v),
                      (B, Sq, H, hd_v))]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


def _kw(case):
    causal, window, cap, kv_len, qc, kc = CASES[case][7:]
    hd = CASES[case][5]
    return dict(causal=causal, window=window, cap=cap, kv_len=kv_len,
                q_chunk=qc, kv_chunk=kc, scale=hd ** -0.5)


def _run(case, dtype, attn_remat):
    """(output, (dq, dk, dv)) of ``sum(o * dy)`` through the port."""
    _, (q, k, v, dy) = _inputs(case, dtype)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = blockwise_attention(q, k, v, attn_remat=attn_remat, **_kw(case))
    grads = torch.autograd.grad((o.float() * dy.float()).sum(), (q, k, v))
    return o.detach(), grads


def _counting(monkeypatch):
    """Count the checkpoints ``blockwise_attention`` enters."""
    seen = []
    real = attention.checkpoint

    def wrapped(fn, *args, **kw):
        seen.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(attention, "checkpoint", wrapped)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flag_on_equals_flag_off_bit_for_bit(case, dtype, monkeypatch):
    seen = _counting(monkeypatch)
    o0, g0 = _run(case, dtype, False)
    assert seen == []
    o1, g1 = _run(case, dtype, True)
    assert seen and set(seen) == {False}      # one a pair, non-reentrant
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    if dtype != torch.float32:
        return
    # the flag on, against the reference's own checkpointed scan
    (q, k, v, dy), _ = _inputs(case, dtype)
    kw = _kw(case)
    if kw["kv_len"] is not None:
        kw["kv_len"] = jnp.asarray(kw["kv_len"], jnp.int32)
    want, vjp = jax.vjp(lambda *a: jattention.blockwise_attention(
        *a, attn_remat=True, **kw), *map(jnp.asarray, (q, k, v)))
    wgrads = vjp(jnp.asarray(dy))
    for got, w in zip((o1, *g1), (want, *wgrads)):
        w = np.asarray(w, np.float64)
        err = np.abs(got.double().numpy() - w).max() / np.abs(w).max()
        assert err <= F32_TOL, (case, err)


def test_saved_bytes_fall_by_the_pairs_scores():
    """One Qwen2-0.5B attention layer (d_model 896, 14/2 heads, hd 64,
    chunks 512/1,024, causal, bf16) at B = 1, S = 2,048: 6 chunk pairs.
    The bytes autograd saves for the backward, each storage counted once,
    fall with the flag on by at least the pairs' f32 scores,
    6 x B·H·512·1,024·4 bytes (~176 MB; ~602 MB against ~28 MB measured
    on the CPU)."""
    cfg = tconfigs.get("qwen2_0_5b").with_(attention_impl="xla_chunked")
    assert (cfg.q_chunk, cfg.kv_chunk) == (512, 1024)
    lspec = cfg.period[0]
    B, S = 1, 2048
    gen = torch.Generator().manual_seed(0)
    p = attn_init(gen, cfg, lspec)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)

    def saved(flag):
        storages = {}

        def pack(t):
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
            return t

        xx = x.clone().requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = attn_apply(p, cfg.with_(attn_remat=flag), lspec, xx,
                           positions=torch.arange(S))
        gx, = torch.autograd.grad(y.float().sum(), xx)
        return sum(storages.values()), y.detach(), gx

    off, y0, g0 = saved(False)
    on, y1, g1 = saved(True)
    n_pairs = 6                        # causal: 4 q chunks, 2 kv chunks
    scores = n_pairs * B * cfg.n_heads * 512 * 1024 * 4
    assert off - on >= scores, (off, on, scores)
    assert torch.equal(y0, y1) and torch.equal(g0, g1)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "deepseek_v2_lite_16b"])
def test_no_grad_enters_no_checkpoint(arch, monkeypatch):
    """Serving and scoring run without a gradient: with ``attn_remat`` on,
    the forward, the loss and the prefill (MLA's too) enter no checkpoint
    and give what the flag off gives; a grad-enabled call on inputs that
    need no gradient enters none either."""
    seen = _counting(monkeypatch)
    tc = tconfigs.get_reduced(arch)
    params = tt.model_init(0, tc, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab, (2, 40)).astype(np.int64))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1),
             "mask": torch.ones(2, 40)}
    got = {}
    for flag in (False, True):
        cfg = tc.with_(attn_remat=flag)
        with torch.no_grad():
            logits, _ = tt.model_apply(params, cfg, batch, mode="train")
            cache = tt.init_cache(cfg, 2, 48, dtype=torch.float32,
                                  device="cpu")
            nxt, cache = tsteps.make_prefill_step(cfg)(params, batch, cache)
        loss = tlm.loss_fn(params, cfg, batch)   # grad on, no leaf
        got[flag] = (logits, nxt, loss)
    assert seen == []
    for a, b in zip(got[False], got[True]):
        assert torch.equal(a, b)
    # the positive control: the same loss under autograd enters them
    tsteps.loss_and_grads(params, tc.with_(attn_remat=True), batch)
    assert seen and set(seen) == {False}


def test_configs_set_the_flag_as_the_reference():
    """Nine of the ten configurations set ``attn_remat`` (all but
    RWKV-6, which has no attention), in full and reduced form, as the
    reference's do."""
    for arch in tconfigs.ARCH_IDS:
        for get, jget in ((tconfigs.get, jconfigs.get),
                          (tconfigs.get_reduced, jconfigs.get_reduced)):
            assert get(arch).attn_remat == jget(arch).attn_remat, arch
    assert [a for a in tconfigs.ARCH_IDS
            if not tconfigs.get(a).attn_remat] == ["rwkv6_3b"]
