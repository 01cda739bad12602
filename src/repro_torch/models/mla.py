"""Multi-head Latent Attention (DeepSeek-V2 [arXiv:2405.04434]).

The port of the reference's ``models/mla.py``.  K/V are compressed to a
rank-``kv_lora_rank`` latent ``c`` plus one RoPE key ``kr`` of
``rope_head_dim`` shared by the heads; the cache holds only those two,
``{"c": (B, S, kv_lora_rank), "kr": (B, S, rope_head_dim)}``, written in
place (prefill from position 0, decode at ``cache_len``).

Train and prefill expand K (nope + rope = 192 wide at deepseek's widths)
and V (128 wide) from the latent and attend with the plain
:func:`~.attention.blockwise_attention`, whatever ``attention_impl``
says, as the reference does.  Decode has the reference's two forms:

* ``absorb=False`` (the default, and the main path's): expand K/V from
  the cached latent every step;
* ``absorb=True``: fold W_uk into the query and W_uv into the output, so
  attention runs in the latent space.

The scale is (nope + rope)^-0.5.  Products the reference asks in f32
(``preferred_element_type``) take their operands upcast to f32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels import _sharded
from .attention import NEG_INF, blockwise_attention
from .config import ArchConfig, LayerSpec
from .layers import (FSDP, TENSOR, dense, dense_init, dense_specs, rmsnorm,
                     rmsnorm_init, rmsnorm_specs, rope, split_heads,
                     write_into)


def mla_init(gen: torch.Generator, cfg: ArchConfig, lspec: LayerSpec, *,
             lead: Tuple[int, ...] = ()):
    m = cfg.mla
    H, D = cfg.n_heads, cfg.d_model
    dq = m.nope_head_dim + m.rope_head_dim
    return {"q": dense_init(gen, D, H * dq, lead=lead),
            "dkv": dense_init(gen, D, m.kv_lora_rank + m.rope_head_dim,
                              lead=lead),
            "kv_norm": rmsnorm_init(m.kv_lora_rank, device=gen.device,
                                    lead=lead),
            "uk": dense_init(gen, m.kv_lora_rank, H * m.nope_head_dim,
                             lead=lead),
            "uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim,
                             lead=lead),
            "o": dense_init(gen, H * m.v_head_dim, D, lead=lead)}


def mla_specs(cfg: ArchConfig, lspec: LayerSpec):
    """The reference's specs for :func:`mla_init`'s leaves."""
    return {"q": dense_specs(), "dkv": dense_specs(out_axis=None),
            "kv_norm": rmsnorm_specs(), "uk": dense_specs(in_axis=None),
            "uv": dense_specs(in_axis=None),
            "o": dense_specs(in_axis=TENSOR, out_axis=FSDP)}


def _expand_kv(p, cfg: ArchConfig, c_kv: torch.Tensor,
               k_rope: torch.Tensor, shd=None):
    """(B,S,R),(B,S,dr) -> k (B,S,H,dn+dr), v (B,S,H,dv)."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    H = cfg.n_heads
    k_nope = split_heads(shd, dense(p["uk"], c_kv), H)
    v = split_heads(shd, dense(p["uv"], c_kv), H)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        B, S, H, m.rope_head_dim)], dim=-1)
    return k, v


def _decode_core(qq, k, v, *, mask, scale: float, dtype):
    """The expanded decode step's attention: (B,1,H,dq) against (B,S,H,*)
    K/V, ``mask`` the written slots.  On DTensors the caller runs it on
    each rank's local (batch, head) shards."""
    s_ = torch.einsum("bshd,bchd->bhsc", qq.float(), k.float()) * scale
    att = torch.softmax(torch.where(mask, s_, NEG_INF), dim=-1)
    return torch.einsum("bhsc,bchv->bshv", att.to(v.dtype).float(),
                        v.float()).to(dtype)


def mla_apply(p, cfg: ArchConfig, lspec: LayerSpec, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: Optional[Dict[str, Any]] = None,
              cache_len: Optional[int] = None, mode: str = "train",
              absorb: bool = False, shd=None, **_) -> torch.Tensor:
    """Returns y; in prefill and decode mode ``cache`` (``{"c", "kr"}``)
    is updated in place.  ``shd``: the model's ``ShardCtx`` (or None)."""
    m = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    dn, dr, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    scale = (dn + dr) ** -0.5

    q = split_heads(shd, dense(p["q"], x), H)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckr = dense(p["dkv"], x)
    c_kv = rmsnorm(p["kv_norm"], ckr[..., :m.kv_lora_rank])
    k_rope = rope(ckr[..., None, m.kv_lora_rank:], positions,
                  cfg.rope_theta)[:, :, 0]        # (B,S,dr)

    if mode in ("train", "prefill"):
        if mode == "prefill":
            write_into(cache["c"], c_kv, 1)
            write_into(cache["kr"], k_rope, 1)
        k, v = _expand_kv(p, cfg, c_kv, k_rope, shd)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        if shd is not None:
            qq, k, v = shd.heads(qq), shd.heads(k), shd.heads(v)
        o = blockwise_attention(qq, k, v, causal=cfg.causal, scale=scale,
                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                attn_remat=cfg.attn_remat)
    elif mode == "decode":
        cc, ckr_c = cache["c"], cache["kr"]
        write_into(cc, c_kv, 1, cache_len)
        write_into(ckr_c, k_rope, 1, cache_len)
        Smax = cc.shape[1]
        mask = torch.arange(Smax, device=x.device) < cache_len + 1
        if absorb:
            # fold W_uk into q: q_c = q_nope @ W_uk(head) -> (B,1,H,R)
            wuk = p["uk"]["w"].reshape(m.kv_lora_rank, H, dn)
            q_c = torch.einsum("bshn,rhn->bshr", q_nope, wuk)
            s_lat = torch.einsum("bshr,bcr->bhsc", q_c.float(), cc.float())
            s_rope = torch.einsum("bshr,bcr->bhsc", q_rope.float(),
                                  ckr_c.float())
            att = torch.softmax(torch.where(mask, (s_lat + s_rope) * scale,
                                            NEG_INF), dim=-1)
            ctx = torch.einsum("bhsc,bcr->bshr",
                               att.to(cc.dtype).float(), cc.float())
            wuv = p["uv"]["w"].reshape(m.kv_lora_rank, H, dv)
            o = torch.einsum("bshr,rhv->bshv", ctx.to(x.dtype), wuv)
        else:
            k, v = _expand_kv(p, cfg, cc, ckr_c, shd)
            qq = torch.cat([q_nope, q_rope], dim=-1)
            kw = dict(mask=mask, scale=scale, dtype=x.dtype)
            o = (_sharded.attention_call(_decode_core, qq, k, v, **kw)
                 if _sharded.is_dtensor(qq) else _decode_core(qq, k, v, **kw))
    else:
        raise ValueError(f"unknown mode {mode!r}")

    return dense(p["o"], o.reshape(B, S, H * dv).to(x.dtype))


def mla_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device: torch.device, lead: Tuple[int, ...] = ()):
    m = cfg.mla
    return {"c": torch.zeros(lead + (batch, max_len, m.kv_lora_rank),
                             dtype=dtype, device=device),
            "kr": torch.zeros(lead + (batch, max_len, m.rope_head_dim),
                              dtype=dtype, device=device)}
