"""The weight carry: the reference's parameter and cache trees, as numpy
leaves, into the port's tensors, and back.

The port keeps the reference's tree layout leaf for leaf, so the carry is
a copy with no reordering and no transpose:

- layer ``l = i·len(period) + j`` of the full periods is
  ``tree["stack"][j]`` at index ``i`` along axis 0 (the reference's
  ``_stack_init``); the ``n_remainder`` layers ``tree["rem"][j]`` follow;
- dense weights stay ``(d_in, d_out)`` and apply as ``x @ w``; the
  embedding stays ``(vocab, d)``;
- ``tree["prefix"]`` is deepseek's dense first layer (a block with a GLU
  FFN of ``first_layer_ffn``), present exactly when ``cfg.n_prefix``;
  ``embed`` is absent and ``head`` present for the audio frontend
  (HuBERT), ``head`` also for an untied unembedding;
- the MoE FFN's leaves: ``router`` (dense, f32), ``w_up`` and ``w_gate``
  ``(E, d_model, d_ff)``, ``w_down`` ``(E, d_ff, d_model)`` (bf16), and
  ``sh_up``, ``sh_gate``, ``sh_down`` (dense) with shared experts; MLA's:
  ``q``, ``dkv``, ``uk``, ``uv``, ``o`` (dense) and ``kv_norm``;
- the recurrent leaves keep the reference's names and shapes: RG-LRU's
  ``in_x``, ``in_g``, ``gate_a``, ``gate_x``, ``out`` (dense),
  ``conv_w`` ``(W, d_rnn)``, ``conv_b``, ``lam``; RWKV-6's ``w_r``,
  ``w_k``, ``w_v``, ``w_g``, ``w_o``, ``lora_a``, ``lora_wa``,
  ``lora_b_{r,k,v,g,w}`` (dense), ``mu_{r,k,v,g,w}``, ``w0``, ``ln_g``
  ``(d_model,)`` and ``u`` ``(H, hd)``; the channel mix's ``w_k``,
  ``w_v``, ``w_r`` and ``mu_k``, ``mu_r``;
- bf16 leaves (numpy's ``bfloat16`` extension type) become
  ``torch.bfloat16`` bit for bit, other dtypes keep theirs.

The cache carries the same way: ``{"stack", "rem", "prefix"}`` of
``{"mixer": ..., "ffn": ...}`` blocks, the mixer's ``{"k", "v"}`` (an
attention layer; a cross layer's ``(B, n_img_tokens, K, hd)``), MLA's
``{"c", "kr"}`` (``(B, S, kv_lora_rank)``, ``(B, S, rope_head_dim)``),
``{"h", "conv"}`` (RG-LRU: ``(B, d_rnn)`` f32 and
``(B, W - 1, d_rnn)``) or ``{"state", "x_prev"}`` (RWKV-6: ``(B, H, hd,
hd)`` f32 and ``(B, d_model)``), the FFN's ``{"x_prev"}`` for the RWKV
channel mix, else ``{}``; ``cache["prefix"]`` is the prefix block's
cache (``{}`` without one); each leaf keeps its dtype, so tests can
compare the prefill and decode caches of both packages.  The layout check
is generic (period slots, the stacked leading axis, the prefix), for
every family.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.batched_pq import resolve_device
from .config import ArchConfig
from .transformer import check_supported


def _leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_from_numpy(tree: Any, device=None) -> Any:
    """Every array leaf of a nested dict / tuple / list as a tensor on
    ``device`` (``None`` means the card)."""
    dev = resolve_device(device)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(go(v) for v in t)
        return _leaf_to_torch(t, dev)

    return go(tree)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse for comparisons: a copy (the caches change in place),
    bf16 tensors as float32 (exact), others in their dtype."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_to_numpy(v) for v in tree)
    t = tree.detach().to("cpu", torch.float32 if tree.dtype == torch.bfloat16
                         else tree.dtype, copy=True)
    return t.numpy()


def _check_layout(tree, cfg: ArchConfig, what: str) -> None:
    has = bool(tree.get("prefix"))
    if has != bool(cfg.n_prefix):
        raise ValueError(f"{what}: {cfg.name} has {cfg.n_prefix} prefix "
                         f"layers, the tree {'one' if has else 'none'}")
    n_full = cfg.n_full_periods
    want = len(cfg.period) if n_full > 0 else 0
    if len(tree["stack"]) != want or len(tree["rem"]) != cfg.n_remainder:
        raise ValueError(
            f"{what}: {len(tree['stack'])} stacks and {len(tree['rem'])} "
            f"remainder layers for {cfg.name}, want {want} and "
            f"{cfg.n_remainder}")

    def leading(t):
        if isinstance(t, dict):
            for v in t.values():
                leading(v)
        elif np.shape(t)[0] != n_full:
            raise ValueError(f"{what}: a stacked leaf of shape "
                             f"{np.shape(t)} for {n_full} full periods")

    for st in tree["stack"]:
        leading(st)


def params_from_numpy(tree: Any, cfg: ArchConfig, device=None) -> Any:
    """The reference's ``model_init`` tree (numpy leaves) as the port's
    parameters for ``cfg``."""
    check_supported(cfg)
    _check_layout(tree, cfg, "params")
    return tree_from_numpy(tree, device)


def cache_from_numpy(tree: Any, cfg: ArchConfig, device=None) -> Any:
    """The reference's ``init_cache`` / prefill / decode cache tree as the
    port's cache for ``cfg`` (updated in place by the port's steps)."""
    check_supported(cfg)
    _check_layout(tree, cfg, "cache")
    return tree_from_numpy(tree, device)
