"""Plain oracle for the flash-attention kernel, in PyTorch.

The torch twin of the reference's ``flash_attention/ref.py``: it
materializes the full (Sq, Skv) score matrix in f32 — O(S^2) memory,
exact softmax.  The kernel and its blockwise plain version are held
against it.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(
    q: torch.Tensor,           # (B, Sq, H, hd)
    k: torch.Tensor,           # (B, Skv, K, hd)
    v: torch.Tensor,           # (B, Skv, K, hd_v)
    *,
    causal: bool = True,
    window: int = 0,           # 0 = unlimited; else k_pos > q_pos - window
    scale: Optional[float] = None,
    cap: float = 0.0,          # logit softcap (gemma2-style); 0 = off
    q_offset: int = 0,         # absolute position of q[0]
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    hd_v = v.shape[-1]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale

    qf = q.float().reshape(B, Sq, K, G, hd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qf, k.float()) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckh->bkgqh", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd_v).to(q.dtype)
