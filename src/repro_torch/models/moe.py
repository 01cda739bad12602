"""Mixture-of-Experts FFN with the reference's sort-based dispatch.

The port of the reference's ``models/moe.py``.  Tokens are ordered by
expert id with a stable sort and moved with gathers and scatters (bytes,
not FLOPs) into (E, C, D) expert buffers; the experts are three batched
products; GShard capacity drops are kept: C = max(1, min(ceil(T·K/E ·
capacity_factor), T)) slots an expert, and the assignments past them add
nothing (the shared expert and the residual carry those tokens).

The steps, each the reference's:

- :func:`route`: the router's logits in f32 from ``x.float()``, softmax,
  the top K by a stable descending sort (ties go to the lower expert id,
  as ``jax.lax.top_k`` breaks them; ``torch.topk`` does not promise that
  on CUDA), renormalised when ``router_norm_topk``;
- :func:`dispatch`: the flat (token, k) assignments stably sorted by
  expert, each one's position in its expert as a cumsum minus
  ``searchsorted(side="left")``, ``keep = pos < C``; a dropped assignment
  points at slot (0, C - 1) and adds zeros there, so the scatter
  (``index_put_(accumulate=True)``) writes each live slot once, exactly;
- the gated expert MLP: with ``moe_bf16_dispatch`` (llama4) the products
  return bf16 (f32 sums inside the GEMM) and the combine runs in bf16;
  otherwise they take their bf16 operands upcast to f32 (exact) and
  return f32 (the reference's ``preferred_element_type=float32``);
- the combine, in a fixed order: each token's K picks, router-weighted
  and masked, are summed one after another in (t, k) order, the most
  probable first (the reference's scatter-add leaves its order open) —
  no atomics, so a replay gives the same bits.

``moe_group_by_batch`` (deepseek) dispatches each batch row alone with a
per-row capacity (T = S), the reference's ``vmap``: here one batched sort
over (B, S·K) rows.  The shared expert is added in f32 and the sum cast
back to x's dtype.  The reference's expert-parallel and FSDP layouts
(``moe_fsdp_axis``, ``moe_ep_serve``) are :func:`moe_specs` and
``launch/sharding.py``'s; the dispatch itself does not run on a mesh of
more than one rank yet (ROADMAP A19b).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .config import ArchConfig
from .layers import FSDP, TENSOR, act_fn, dense, dense_init, dense_specs, spec


def moe_init(gen: torch.Generator, cfg: ArchConfig, *,
             lead: Tuple[int, ...] = ()):
    m = cfg.moe
    D, F, E = cfg.d_model, m.d_ff, m.n_experts
    dev = gen.device

    def experts(d_in, d_out):
        w = torch.randn(lead + (E, d_in, d_out), generator=gen,
                        dtype=torch.float32, device=dev)
        return (w * d_in ** -0.5).to(torch.bfloat16)

    p = {"router": dense_init(gen, D, E, dtype=torch.float32, lead=lead),
         "w_up": experts(D, F), "w_gate": experts(D, F),
         "w_down": experts(F, D)}
    if m.n_shared:
        fs = (m.d_ff_shared or m.d_ff) * m.n_shared
        p["sh_up"] = dense_init(gen, D, fs, lead=lead)
        p["sh_gate"] = dense_init(gen, D, fs, lead=lead)
        p["sh_down"] = dense_init(gen, fs, D, lead=lead)
    return p


def moe_specs(cfg: ArchConfig):
    """The reference's specs for :func:`moe_init`'s leaves
    (``moe_fsdp_axis``: the expert weights' FSDP dim)."""
    s = {"router": dense_specs(out_axis=None)}
    if cfg.moe_fsdp_axis == "f":
        # Megatron-style: split the expert FFN dim
        s.update(w_up=spec(TENSOR, None, FSDP), w_gate=spec(TENSOR, None, FSDP),
                 w_down=spec(TENSOR, FSDP, None))
    else:
        s.update(w_up=spec(TENSOR, FSDP, None), w_gate=spec(TENSOR, FSDP, None),
                 w_down=spec(TENSOR, None, FSDP))
    if cfg.moe.n_shared:
        s.update(sh_up=dense_specs(), sh_gate=dense_specs(),
                 sh_down=dense_specs(in_axis=TENSOR, out_axis=FSDP))
    return s


def router_probs(p, xt: torch.Tensor) -> torch.Tensor:
    """(..., T, D) tokens -> (..., T, E) router probabilities in f32."""
    return torch.softmax(dense(p["router"], xt.float()), dim=-1)


def route(p, cfg: ArchConfig,
          xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top_p, top_e), each (..., T, K): the K most probable experts of
    each token, most probable first, ties to the lower expert id."""
    m = cfg.moe
    top_p, top_e = torch.sort(router_probs(p, xt), dim=-1, descending=True,
                              stable=True)
    top_p, top_e = top_p[..., :m.top_k], top_e[..., :m.top_k]
    if m.router_norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    return top_p, top_e


def capacity(cfg: ArchConfig, T: int) -> int:
    """Slots an expert for a group of T tokens (the reference's C)."""
    m = cfg.moe
    C = int(math.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
    return max(1, min(C, T))


def dispatch(top_e: torch.Tensor, n_experts: int,
             C: int) -> Dict[str, torch.Tensor]:
    """The sort-based dispatch of (G, T, K) expert ids, each group alone:
    ``order`` (the stable sort of the flat assignments by expert), the
    sorted ``se`` (expert) and ``st`` (token), ``pos`` (place in its
    expert), ``keep``, and the buffer slot ``(slot_e, slot_c)`` of each
    sorted assignment, all (G, T·K)."""
    G, T, K = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    st = torch.div(order, K, rounding_mode="floor")   # flat index t·K + k
    pos_in_all = torch.arange(T * K, device=dev).expand(G, -1)
    seg_start = torch.searchsorted(
        se, torch.arange(n_experts, device=dev).expand(G, -1).contiguous(),
        side="left")
    pos = pos_in_all - torch.gather(seg_start, -1, se)
    keep = pos < C
    return {"order": order, "se": se, "st": st, "pos": pos, "keep": keep,
            "slot_e": torch.where(keep, se, 0),
            "slot_c": torch.where(keep, pos, C - 1)}


def _expert_mm(a: torch.Tensor, w: torch.Tensor,
               acc: torch.dtype) -> torch.Tensor:
    """(E, N, X) @ (E, X, Y) -> (E, N, Y) in ``acc``, the reference's
    ``einsum(..., preferred_element_type=acc)``: operands of ``acc``'s
    dtype go as they are (a bf16 GEMM sums in f32 and rounds once); other
    pairs are upcast to f32, exactly, and the result cast to ``acc``."""
    if a.dtype == w.dtype == acc:
        return torch.bmm(a, w)
    return torch.bmm(a.float(), w.float()).to(acc)


def _routed(p, cfg: ArchConfig, xt: torch.Tensor, act) -> torch.Tensor:
    """Sort-based dispatch over G token groups xt (G, T, D), each with its
    own capacity.  Returns (G, T, D) in the combine's dtype."""
    G, T, D = xt.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    dev = xt.device
    top_p, top_e = route(p, cfg, xt)
    C = capacity(cfg, T)
    d = dispatch(top_e, E, C)
    keep, slot_e, slot_c = d["keep"], d["slot_e"], d["slot_c"]
    gi = torch.arange(G, device=dev)[:, None].expand(G, T * K)

    # scatter tokens into (E, G, C, D) expert buffers: the live slots get
    # their token, the dropped assignments zeros at (0, C - 1)
    tok = torch.where(keep[..., None], xt[gi, d["st"]], 0)
    buf = xt.new_zeros((E, G, C, D))
    buf.index_put_((slot_e, gi, slot_c), tok, accumulate=True)
    buf = buf.reshape(E, G * C, D)

    # the gated expert MLP
    acc = torch.bfloat16 if cfg.moe_bf16_dispatch else torch.float32
    h = act(_expert_mm(buf, p["w_gate"], acc).float()) \
        * _expert_mm(buf, p["w_up"], acc).float()
    out_buf = _expert_mm(h.to(xt.dtype), p["w_down"], acc)
    out_buf = out_buf.reshape(E, G, C, D)

    # each (t, k) pick in (t, k) order: its place among the sorted
    # assignments is inv[t·K + k]
    inv = torch.empty_like(d["order"])
    inv.scatter_(-1, d["order"], torch.arange(T * K, device=dev)
                 .expand(G, -1).contiguous())
    comb = xt.dtype if cfg.moe_bf16_dispatch else torch.float32
    e_, c_ = torch.gather(slot_e, -1, inv), torch.gather(slot_c, -1, inv)
    w_ = top_p.reshape(G, T * K).to(comb)
    picked = out_buf[e_, gi, c_].to(comb) * w_[..., None]
    picked = torch.where(torch.gather(keep, -1, inv)[..., None], picked, 0)
    picked = picked.reshape(G, T, K, D)
    y = picked[:, :, 0]
    for k in range(1, K):
        y = y + picked[:, :, k]
    return y


def moe_apply(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Routed FFN of x (B, S, D), plus the shared expert; x's dtype.  On
    a DTensor (a sharded step) it raises ``NotImplementedError``: DTensor
    has no sharding rule for the dispatch's sort and searchsorted, and a
    per-shard dispatch would change the capacity (ROADMAP A19b)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        raise NotImplementedError(
            "the MoE dispatch does not run on a mesh of DTensors yet "
            "(ROADMAP A19b)")
    m = cfg.moe
    B, S, D = x.shape
    act = act_fn(cfg.ffn_act)
    groups = x if cfg.moe_group_by_batch else x.reshape(1, B * S, D)
    y = _routed(p, cfg, groups, act).float().reshape(B, S, D)
    if m.n_shared:
        xt = x.reshape(B * S, D)
        g = act(dense(p["sh_gate"], xt).float())
        u = dense(p["sh_up"], xt).float()
        y = y + dense(p["sh_down"], (g * u).to(x.dtype)).float() \
            .reshape(B, S, D)
    return y.to(x.dtype)
