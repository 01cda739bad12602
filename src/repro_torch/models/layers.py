"""Primitive layers: parameter init and pure apply, on torch tensors.

The port of the reference's ``models/layers.py``.  Parameters are nested
dicts of tensors with the reference's names and layouts: a dense weight
is ``(d_in, d_out)`` and applies as ``x @ w`` (no transpose anywhere), an
embedding is ``(vocab, d)``.  Every ``*_init`` takes a ``torch.Generator``
on the target device and ``lead``, the leading shape of a stack of layers
(``()`` for one), and draws the reference's distributions (normal scaled
by ``d_in ** -0.5``, zero biases, unit f32 norm gains), not its bits.  The
reference's sharding specs (``spec``/``resolve_specs``) are not carried
over: the port's trainer runs on one device (ROADMAP A19).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float = 0.0,
               dtype: torch.dtype = torch.bfloat16,
               lead: Tuple[int, ...] = ()) -> Params:
    scale = scale or d_in ** -0.5
    p: Params = {"w": _normal(gen, lead + (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, *, device: torch.device,
                 lead: Tuple[int, ...] = ()) -> Params:
    return {"g": torch.ones(lead + (d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In f32 with an f32 gain, cast back to x's dtype."""
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["g"]).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.bfloat16) -> Params:
    return {"e": _normal(gen, (vocab, d), d ** -0.5, dtype)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, p["e"])


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits over the vocab."""
    return x @ p["e"].T


# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim, rotating the split halves (not
    interleaved pairs), in f32 and cast back.  x: (..., S, H, hd),
    positions (S,) or (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]
