"""Attention family: GQA full / local / cross attention, chunked online
softmax.

The port of the reference's ``models/attention.py``.  The full-sequence
forward (``mode="train"``) picks its attention by ``cfg.attention_impl``:
``"pallas"`` is the reference's switch for the kernel path and here runs
the hand-written CUDA flash-attention kernel (``kernels/flash_attention``;
its plain version on CPU tensors), ``"xla_chunked"`` the plain torch twin
of the reference's blockwise scan (:func:`blockwise_attention`),
``"naive"`` the O(S^2) oracle.  None of them is a fallback for another.
Prefill attends with :func:`blockwise_attention` and decode (Sq == 1) with
:func:`decode_attention` against the cache, whatever ``attention_impl``
says, as in the reference.  A local layer's decode attends the forward's
window once its ring is full, where the reference attends one position
more (:func:`decode_attention`).

Caches are updated in place (the reference returns new arrays): prefill
writes the prompt's K/V into the zeroed cache, or the last ``Smax`` of
them rolled into the ring of a local layer; decode writes one slot.

Cross-attention (the VLM's ``lspec.cross_attn`` layers) attends the
context ``ctx`` (the image embeddings, (B, n_img_tokens, D)) with no rope
and no mask, as the reference does: ``naive_attention`` in train and
prefill, whatever ``attention_impl`` says; prefill writes the image K/V
into the layer's (B, n_img_tokens, K, hd) cache, and decode attends that
cache with :func:`decode_attention` (every slot valid) and leaves it as
it is.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import _sharded
from ..kernels.flash_attention import flash_attention
from .config import ArchConfig, LayerSpec
from .layers import (FSDP, TENSOR, dense, dense_init, dense_specs, rope, softcap,
                     merge_heads, split_heads, write_into)

NEG_INF = -1e30
IMPLS = ("xla_chunked", "naive", "pallas")


def attn_init(gen: torch.Generator, cfg: ArchConfig, lspec: LayerSpec, *,
              lead: Tuple[int, ...] = ()):
    H, K, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return {"q": dense_init(gen, D, H * hd, bias=cfg.qkv_bias, lead=lead),
            "k": dense_init(gen, D, K * hd, bias=cfg.qkv_bias, lead=lead),
            "v": dense_init(gen, D, K * hd, bias=cfg.qkv_bias, lead=lead),
            "o": dense_init(gen, H * hd, D, lead=lead)}


def attn_specs(cfg: ArchConfig, lspec: LayerSpec):
    """The reference's specs for :func:`attn_init`'s leaves."""
    b = cfg.qkv_bias
    return {"q": dense_specs(bias=b), "k": dense_specs(bias=b),
            "v": dense_specs(bias=b),
            "o": dense_specs(in_axis=TENSOR, out_axis=FSDP)}


# ---------------------------------------------------------------------------
def _block_pairs(nq: int, nkv: int, q_chunk: int, kv_chunk: int,
                 causal: bool, window: int) -> List[Tuple[int, List[int]]]:
    """Each q chunk with the kv chunks it visits, in the reference's static
    order (causal / local pruning)."""
    out = []
    for i in range(nq):
        q_lo, q_hi = i * q_chunk, (i + 1) * q_chunk - 1
        js = []
        for j in range(nkv):
            k_lo, k_hi = j * kv_chunk, (j + 1) * kv_chunk - 1
            if causal and k_lo > q_hi:
                continue                       # fully above the diagonal
            if window and k_hi < q_lo - window + 1:
                continue                       # fully outside the window
            js.append(j)
        if js:
            out.append((i, js))
    return out


def _pair(qi, kj, vj, m, l, acc, q_pos, k_pos, *, scale: float, cap: float,
          valid_kv: int, causal: bool, window: int):
    """One (q chunk, kv chunk) step of the online softmax: the scores with
    f32 accumulation, softcap, mask, running max, exponentials and the
    ``l`` / ``acc`` update.  Returns (m_new, l, acc)."""
    s = (qi @ kj.transpose(-1, -2)) * scale
    s = softcap(s, cap)
    mask = k_pos < valid_kv
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + p.to(vj.dtype).float() @ vj.float()
    return m_new, l, acc


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0, scale: float,
                        cap: float = 0.0, q_chunk: int, kv_chunk: int,
                        kv_len: Optional[int] = None,
                        attn_remat: bool = False) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,K,hd). Returns (B,Sq,H,hd_v).

    The plain torch twin of the reference's scan: the same chunk pairs,
    scores with f32 accumulation, the probabilities cast to v's dtype
    before p·v (as the reference does), each q chunk's result cast to q's
    dtype.  ``kv_len``: valid length of k/v.  ``attn_remat`` (the
    reference's ``jax.checkpoint(step)``): under autograd each chunk pair
    runs under ``torch.utils.checkpoint`` (non-reentrant), so the backward
    recomputes the pair's scores, mask and exponentials instead of keeping
    them; the result and every gradient are bit-equal to the flag off.
    Without a gradient it changes nothing.  On DTensors it runs on each
    rank's local (batch, q-head) shards, as the kernels do
    (``kernels/_sharded.py``'s ``attention_call``)."""
    if _sharded.is_dtensor(q):
        return _sharded.attention_call(
            blockwise_attention, q, k, v, causal=causal, window=window,
            scale=scale, cap=cap, q_chunk=q_chunk, kv_chunk=kv_chunk,
            kv_len=kv_len, attn_remat=attn_remat)
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    hd_v = v.shape[-1]
    G = H // K
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    pad_q = (-Sq) % q_chunk
    pad_kv = (-Skv) % kv_chunk
    nq, nkv = (Sq + pad_q) // q_chunk, (Skv + pad_kv) // kv_chunk
    dev = q.device
    # (B, K, G, S, hd) queries, (B, K, 1, S, hd) keys and values
    qf = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q)).float()
    qf = qf.reshape(B, nq * q_chunk, K, G, hd).permute(0, 2, 3, 1, 4)
    kf = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
    vf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    kf = kf.float().permute(0, 2, 1, 3)[:, :, None]
    vf = vf.permute(0, 2, 1, 3)[:, :, None]
    pair = functools.partial(
        _pair, scale=scale, cap=cap, causal=causal, window=window,
        valid_kv=Skv if kv_len is None else kv_len)
    remat = attn_remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    # each q chunk's rows (zeros for a chunk no kv chunk reaches), joined
    # by one cat: no in-place write into a buffer, so the same code runs
    # on DTensors
    rows = [None] * nq
    ar_q = torch.arange(q_chunk, device=dev)
    ar_k = torch.arange(kv_chunk, device=dev)
    for i, js in _block_pairs(nq, nkv, q_chunk, kv_chunk, causal, window):
        qi = qf[:, :, :, i * q_chunk:(i + 1) * q_chunk]
        q_pos = (i * q_chunk + ar_q)[:, None]
        m = torch.full((B, K, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, K, G, q_chunk), device=dev)
        acc = torch.zeros((B, K, G, q_chunk, hd_v), device=dev)
        for j in js:
            kj = kf[:, :, :, j * kv_chunk:(j + 1) * kv_chunk]
            vj = vf[:, :, :, j * kv_chunk:(j + 1) * kv_chunk]
            k_pos = (j * kv_chunk + ar_k)[None, :]
            args = (qi, kj, vj, m, l, acc, q_pos, k_pos)
            m, l, acc = (checkpoint(pair, *args, use_reentrant=False)
                         if remat else pair(*args))
        rows[i] = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    rows = [r if r is not None else
            torch.zeros((B, K, G, q_chunk, hd_v), dtype=q.dtype, device=dev)
            for r in rows]
    out = torch.cat(rows, dim=3) if nq > 1 else rows[0]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, nq * q_chunk, H, hd_v)
    return out[:, :Sq]


def naive_attention(q, k, v, *, causal, window=0, scale, cap=0.0,
                    kv_len=None):
    """Reference O(S^2)-memory attention (oracle for tests).  On DTensors
    it runs on each rank's local (batch, q-head) shards."""
    if _sharded.is_dtensor(q):
        return _sharded.attention_call(
            naive_attention, q, k, v, causal=causal, window=window,
            scale=scale, cap=cap, kv_len=kv_len)
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    hd_v = v.shape[-1]
    G = H // K
    qr = q.reshape(B, Sq, K, G, hd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qr.float(), k.float()) * scale
    s = softcap(s, cap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask &= k_pos < kv_len
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckh->bkgqh", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd_v).to(q.dtype)


def decode_attention(q, k_cache, v_cache, n_valid: int, *, scale, cap=0.0,
                     stale: Optional[int] = None):
    """One-token attention against a (B,Smax,K,hd) cache. q: (B,1,H,hd).

    ``n_valid``: number of written cache slots.  ``stale``: a written slot
    not to attend.  A local layer's ring cache holds window + 1 slots;
    once it is full, the slot of the oldest position (cache_len - window)
    is ``stale``, so the step attends the ``window`` positions the
    full-sequence forward attends (``k_pos > q_pos - window``).  (The
    reference attends every written slot: window + 1 positions once its
    ring is full, one more than its own forward.)  On DTensors it runs on
    each rank's local (batch, head) shards, unless the cache is sharded
    along its sequence (a KV-head count that does not divide the model
    axis): then DTensor reduces the softmax and p·v across the shards.
    """
    if _sharded.is_dtensor(k_cache) and not any(
            getattr(p, "dim", None) == 1 for p in k_cache.placements):
        # the cache whole along the sequence: local per (batch, head)
        return _sharded.attention_call(
            decode_attention, q, k_cache, v_cache, n_valid=n_valid,
            scale=scale, cap=cap, stale=stale)
    if _sharded.is_dtensor(q):
        # the cache's sequence is sharded: q's heads whole on every rank
        # (a (K, G) split of a head shard need not divide)
        from torch.distributed.tensor import Replicate, Shard

        q = q.redistribute(q.device_mesh, [
            Replicate() if p == Shard(2) else p for p in q.placements])
    B, _, H, hd = q.shape
    _, Smax, K, _ = k_cache.shape
    hd_v = v_cache.shape[-1]
    G = H // K
    qr = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bckh->bkgc", qr.float(), k_cache.float()) * scale
    s = softcap(s, cap)
    slots = torch.arange(Smax, device=q.device)
    mask = slots < n_valid
    if stale is not None:
        mask = mask & (slots != stale)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckh->bkgh", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd_v).to(q.dtype)


# ---------------------------------------------------------------------------
def attn_apply(p, cfg: ArchConfig, lspec: LayerSpec, x: torch.Tensor, *,
               positions: torch.Tensor,
               ctx: Optional[torch.Tensor] = None,
               cache: Optional[Dict[str, Any]] = None,
               cache_len: Optional[int] = None,
               mode: str = "train", shd=None) -> torch.Tensor:
    """Self or cross attention.  Returns y; in prefill and decode mode
    ``cache`` (``{"k", "v"}``) is updated in place (a cross layer's only
    at prefill).  ``shd``: the model's ``ShardCtx`` (or None)."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = cfg.attn_scale or hd ** -0.5
    cross = lspec.cross_attn
    causal = cfg.causal and not cross
    window = lspec.window if lspec.mixer == "local" else 0

    q = split_heads(shd, dense(p["q"], x), H)
    if cross and mode == "decode":
        k = v = None          # the image K/V were cached at prefill
    else:
        src = ctx if cross else x
        k = split_heads(shd, dense(p["k"], src), K)
        v = split_heads(shd, dense(p["v"], src), K)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if shd is not None and mode in ("train", "prefill"):
        q = shd.heads(q)
        if k is not None:
            k, v = shd.heads(k), shd.heads(v)

    if cross and mode in ("train", "prefill"):
        if mode == "prefill":
            if tuple(cache["k"].shape) != tuple(k.shape):
                raise ValueError(
                    f"a cross layer's cache holds {tuple(cache['k'].shape)} "
                    f"K/V, the context gives {tuple(k.shape)}")
            write_into(cache["k"], k)
            write_into(cache["v"], v)
        o = naive_attention(q, k, v, causal=False, scale=scale,
                            cap=cfg.attn_softcap)
    elif cross and mode == "decode":
        o = decode_attention(q, cache["k"], cache["v"], cache["k"].shape[1],
                             scale=scale, cap=cfg.attn_softcap)
    elif mode == "train":
        impl = cfg.attention_impl
        if impl == "naive":
            o = naive_attention(q, k, v, causal=causal, window=window,
                                scale=scale, cap=cfg.attn_softcap)
        elif impl == "pallas":
            o = flash_attention(q, k, v, causal=causal, window=window,
                                scale=scale, cap=cfg.attn_softcap,
                                block_q=min(cfg.q_chunk, 128),
                                block_k=min(cfg.kv_chunk, 128))
        elif impl == "xla_chunked":
            o = blockwise_attention(q, k, v, causal=causal, window=window,
                                    scale=scale, cap=cfg.attn_softcap,
                                    q_chunk=cfg.q_chunk,
                                    kv_chunk=cfg.kv_chunk,
                                    attn_remat=cfg.attn_remat)
        else:
            raise ValueError(f"attention_impl must be one of {IMPLS}, got "
                             f"{impl!r}")
    elif mode == "prefill":
        ck, cv = cache["k"], cache["v"]
        Smax = ck.shape[1]
        if S >= Smax:
            # ring cache (local layers): keep the last Smax tokens at
            # slots t % Smax (token t lands at slot t mod Smax)
            write_into(ck, torch.roll(k[:, S - Smax:], S % Smax, dims=1))
            write_into(cv, torch.roll(v[:, S - Smax:], S % Smax, dims=1))
        else:
            write_into(ck, k, 1)
            write_into(cv, v, 1)
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                scale=scale, cap=cfg.attn_softcap,
                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    elif mode == "decode":  # S == 1
        ck, cv = cache["k"], cache["v"]
        Smax = ck.shape[1]
        slot = cache_len % Smax                  # ring for local layers
        write_into(ck, k, 1, slot)
        write_into(cv, v, 1, slot)
        # a full ring of window + 1 slots also holds position
        # cache_len - window, outside the window: its slot is the next one
        stale = (cache_len + 1) % Smax if window and cache_len >= window \
            else None
        o = decode_attention(q, ck, cv, min(cache_len + 1, Smax),
                             scale=scale, cap=cfg.attn_softcap, stale=stale)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    return dense(p["o"], merge_heads(shd, o))


def attn_cache_init(cfg: ArchConfig, lspec: LayerSpec, batch: int,
                    max_len: int, dtype: torch.dtype = torch.bfloat16, *,
                    device: torch.device, lead: Tuple[int, ...] = ()):
    K, hd = cfg.n_kv_heads, cfg.head_dim
    if lspec.cross_attn:
        max_len = cfg.n_img_tokens
    elif lspec.mixer == "local" and lspec.window:
        max_len = min(max_len, lspec.window + 1)
    shape = lead + (batch, max_len, K, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
