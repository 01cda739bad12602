"""Plain oracles for the linear-recurrence kernels, in PyTorch.

The torch twins of the reference's ``linear_scan/ref.py``: exact
step-by-step scans in f32, one Python step per token.  The kernels and
the chunked plain version are held against them.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rwkv6_reference(
    r: torch.Tensor,       # (B, S, H, hd)
    k: torch.Tensor,       # (B, S, H, hd)
    v: torch.Tensor,       # (B, S, H, hd)
    w: torch.Tensor,       # (B, S, H, hd) — per-channel decay in (0, 1]
    u: torch.Tensor,       # (H, hd)       — current-token bonus
    state0: torch.Tensor,  # (B, H, hd, hd) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact step-by-step RWKV-6 recurrence.

    y_t = r_t · (S_{t-1} + u∘(k_t⊗v_t));  S_t = w_t∘S_{t-1} + k_t⊗v_t.
    Returns (y (B,S,H,hd) f32, final_state (B,H,hd,hd) f32).
    """
    rs, ks, vs, ws = (t.float() for t in (r, k, v, w))
    uf = u.float()[..., None]
    state = state0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rs[:, t], state + uf * kv))
        state = ws[:, t, :, :, None] * state + kv
    if not ys:
        return torch.zeros(r.shape, dtype=torch.float32,
                           device=r.device), state
    return torch.stack(ys, 1), state


def rglru_reference(
    a: torch.Tensor,       # (B, S, R) f32 — per-channel decay in (0, 1]
    b: torch.Tensor,       # (B, S, R) f32 — input term
    h0: torch.Tensor,      # (B, R) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t.  Returns (h (B,S,R), h_final (B,R))."""
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs, h
