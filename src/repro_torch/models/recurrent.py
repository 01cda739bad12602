"""Recurrent mixers: RG-LRU (Griffin/RecurrentGemma) and RWKV-6 (Finch).

The port of the reference's ``models/recurrent.py``: the RG-LRU block
with its causal depthwise conv, the RWKV-6 time-mix with its LoRA
token-shift mixing and data-dependent decay, the RWKV channel-mix (the
Finch FFN), and their caches.  Parameters keep the reference's leaves and
layouts (dense weights ``(d_in, d_out)``, applied as ``x @ w``), drawn
from a ``torch.Generator`` like the dense layers.

**The path that drives the kernels.**  The reference's mixers run their
own recurrences (an ``associative_scan`` for RG-LRU, a time-step
``lax.scan`` for RWKV-6) and name the Pallas kernels only in a docstring.
The port runs the recurrences through the linear-scan entry points
(``kernels/linear_scan``), so on the card they run the hand-written
``rglru_scan`` and ``rwkv6_scan`` kernels:

- ``rwkv6_apply`` computes its recurrence with ``rwkv6_scan`` in every
  mode: ``train`` and ``prefill`` over the sequence, ``decode`` with
  S = 1 (the reference's decode also runs its scan), from the cache's
  ``state`` in ``prefill`` and ``decode``, from zeros in ``train``.
- ``rglru_apply`` computes its recurrence with ``rglru_scan`` in
  ``train`` and ``prefill`` mode, from zeros as the reference does (its
  prefill ignores ``cache["h"]``); ``decode`` keeps the reference's
  one-step formula ``h = a·h_prev + b`` (a product, then a sum).

The results therefore equal the reference's to f32 rounding, not bit for
bit.  The mixers reach the scans through the module-level seam
:data:`SCANS`; pointing it at the plain versions (``rwkv6_scan_plain``,
``rglru_scan_plain``) gives the plain path that ``chip_smoke.py``
compares the kernel path with on the card.  The seam is not a config
field, a flag or an environment variable.

Caches are updated in place (the reference returns new arrays): each
mixer writes its new ``state``, ``h``, ``conv`` and ``x_prev`` into
the cache tensors, in their dtypes.  ``state`` and ``h`` are f32;
``x_prev`` and ``conv`` take the cache's dtype (bf16 by default, where
the reference always rounds them to bf16).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import linear_scan
from .config import ArchConfig, LayerSpec
from .layers import (FSDP, TENSOR, dense, dense_init, dense_specs, spec,
                     split_heads, write_into)

# the seam: the scans the mixers call (see the module docstring)
SCANS = {"rwkv6": linear_scan.rwkv6_scan, "rglru": linear_scan.rglru_scan}


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin, arXiv:2402.19427)
# ---------------------------------------------------------------------------
_RG_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ArchConfig, lspec: LayerSpec, *,
               lead: Tuple[int, ...] = ()):
    D, R, W = cfg.d_model, cfg.d_rnn, cfg.conv_width
    dev = gen.device
    conv = torch.randn(lead + (W, R), generator=gen, dtype=torch.float32,
                       device=dev)
    # Lambda init so that a = sigmoid(L) in ~(0.9, 0.999)
    lam = torch.rand(lead + (R,), generator=gen, dtype=torch.float32,
                     device=dev) * (7.0 - 2.2) + 2.2
    return {"in_x": dense_init(gen, D, R, lead=lead),
            "in_g": dense_init(gen, D, R, lead=lead),
            "conv_w": (conv * (1.0 / W)).to(torch.bfloat16),
            "conv_b": _zeros(lead + (R,), torch.bfloat16, dev),
            "gate_a": dense_init(gen, R, R, lead=lead),
            "gate_x": dense_init(gen, R, R, lead=lead),
            "lam": lam,
            "out": dense_init(gen, R, D, lead=lead)}


def rglru_specs(cfg: ArchConfig, lspec: LayerSpec):
    """The reference's specs for :func:`rglru_init`'s leaves."""
    return {"in_x": dense_specs(), "in_g": dense_specs(),
            "conv_w": spec(None, TENSOR), "conv_b": spec(TENSOR),
            "gate_a": dense_specs(in_axis=None),
            "gate_x": dense_specs(in_axis=None), "lam": spec(TENSOR),
            "out": dense_specs(in_axis=TENSOR, out_axis=FSDP)}


def _causal_conv(p, u: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width W over u (B, S, R), ``prev`` the
    (B, W-1, R) history or None (zeros).  Returns (out, the padded input
    whose last W-1 rows are the next history)."""
    W = p["conv_w"].shape[0]
    if prev is None:
        pad = _zeros((u.shape[0], W - 1, u.shape[2]), u.dtype, u.device)
    else:
        pad = prev.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = full[:, 0:S] * p["conv_w"][W - 1]
    for i in range(1, W):
        out = out + full[:, i:i + S] * p["conv_w"][W - 1 - i]
    return out + p["conv_b"], full


def rglru_apply(p, cfg: ArchConfig, lspec: LayerSpec, x: torch.Tensor, *,
                cache: Optional[Dict[str, Any]] = None,
                mode: str = "train", **_) -> torch.Tensor:
    """The RG-LRU block.  Returns y; in prefill and decode mode ``cache``
    (``{"h", "conv"}``) is updated in place."""
    u = dense(p["in_x"], x)
    g = F.gelu(dense(p["in_g"], x).float(), approximate="tanh")
    uc, full = _causal_conv(p, u, cache["conv"] if cache is not None
                            else None)

    r = torch.sigmoid(dense(p["gate_a"], uc).float())
    i = torch.sigmoid(dense(p["gate_x"], uc).float())
    log_a = -_RG_C * r * F.softplus(p["lam"])            # (B, S, R) f32
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uc.float())

    if mode == "decode":
        h_prev = cache["h"]                              # (B, R) f32
        h = a[:, 0] * h_prev
        h = h + b[:, 0]
        hs = h[:, None]
        write_into(cache["h"], h)
    elif mode in ("train", "prefill"):
        h0 = _zeros(a[:, 0].shape, torch.float32, a.device)
        hs, h = SCANS["rglru"](a, b, h0)                 # h_t, zero init
        if mode == "prefill":
            write_into(cache["h"], h)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "train":
        W = p["conv_w"].shape[0]
        write_into(cache["conv"], full[:, full.shape[1] - (W - 1):])
    return dense(p["out"], (hs * g).to(x.dtype))


def rglru_cache_init(cfg: ArchConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16, *,
                     device: torch.device, lead: Tuple[int, ...] = ()):
    return {"h": _zeros(lead + (batch, cfg.d_rnn), torch.float32, device),
            "conv": _zeros(lead + (batch, cfg.conv_width - 1, cfg.d_rnn),
                           dtype, device)}


# ---------------------------------------------------------------------------
# RWKV-6 time-mix (Finch, arXiv:2404.05892)
# ---------------------------------------------------------------------------
_LORA_R = 32


def rwkv6_init(gen: torch.Generator, cfg: ArchConfig, lspec: LayerSpec, *,
               lead: Tuple[int, ...] = ()):
    D = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = D // hd
    dev = gen.device
    p: Dict[str, Any] = {f"w_{n}": dense_init(gen, D, D, lead=lead)
                         for n in "rkvgo"}
    # token-shift mixing: static mu per stream + shared low-rank dynamic part
    for n in "rkvgw":
        p[f"mu_{n}"] = torch.full(lead + (D,), 0.5, dtype=torch.float32,
                                  device=dev)
    p["lora_a"] = dense_init(gen, D, _LORA_R, lead=lead)
    for n in "rkvgw":
        p[f"lora_b_{n}"] = dense_init(gen, _LORA_R, D, scale=0.01, lead=lead)
    # decay: w_t = exp(-exp(w0 + tanh(x_w @ A_w) @ B_w))
    p["lora_wa"] = dense_init(gen, D, _LORA_R, lead=lead)
    p["w0"] = torch.full(lead + (D,), -1.5, dtype=torch.float32, device=dev)
    p["u"] = _zeros(lead + (H, hd), torch.float32, dev)        # bonus
    p["ln_g"] = torch.ones(lead + (D,), dtype=torch.float32, device=dev)
    return p


def rwkv6_specs(cfg: ArchConfig, lspec: LayerSpec):
    """The reference's specs for :func:`rwkv6_init`'s leaves."""
    s = {f"w_{n}": dense_specs() for n in "rkvg"}
    s["w_o"] = dense_specs(in_axis=TENSOR, out_axis=FSDP)
    for n in "rkvgw":
        s[f"mu_{n}"] = spec(None)
        s[f"lora_b_{n}"] = dense_specs(in_axis=None, out_axis=None)
    s["lora_a"] = dense_specs(out_axis=None)
    s["lora_wa"] = dense_specs(out_axis=None)
    s.update(w0=spec(None), u=spec(None, None), ln_g=spec(None))
    return s


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The x_{t-1} stream; x_prev is the final token of the previous
    segment (zeros without a cache)."""
    if x_prev is None:
        first = torch.zeros_like(x[:, :1])
    else:
        first = x_prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv6_apply(p, cfg: ArchConfig, lspec: LayerSpec, x: torch.Tensor, *,
                cache: Optional[Dict[str, Any]] = None,
                mode: str = "train", shd=None, **_) -> torch.Tensor:
    """The RWKV-6 time-mix.  Returns y; in prefill and decode mode
    ``cache`` (``{"state", "x_prev"}``) is updated in place.  ``shd``: the
    model's ``ShardCtx`` (or None), which keeps each head whole on one
    rank."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd

    xp = _token_shift(x, cache["x_prev"] if cache is not None else None)
    delta = (xp - x).float()
    lora = torch.tanh(dense(p["lora_a"], x)).float()
    xf = x.float()

    def mixed(n):
        mix = p[f"mu_{n}"] + lora @ p[f"lora_b_{n}"]["w"].float()
        return (xf + delta * mix).to(x.dtype)

    r = split_heads(shd, dense(p["w_r"], mixed("r")), H)
    k = split_heads(shd, dense(p["w_k"], mixed("k")), H)
    v = split_heads(shd, dense(p["w_v"], mixed("v")), H)
    g = F.silu(dense(p["w_g"], mixed("g")).float())
    xw = torch.tanh(dense(p["lora_wa"], mixed("w"))).float()
    logw = -torch.exp(p["w0"] + xw @ p["lora_b_w"]["w"].float())
    w = split_heads(shd, torch.exp(logw), H)    # per-channel decay in (0,1)

    state0 = (cache["state"] if cache is not None
              else _zeros((B, H, hd, hd), torch.float32, x.device))
    y, state = SCANS["rwkv6"](r, k, v, w, p["u"], state0)

    # per-head group norm, then output gate
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y.reshape(B, S, D) * p["ln_g"] * g
    out = dense(p["w_o"], y.to(x.dtype))

    if mode != "train":
        write_into(cache["state"], state)
        write_into(cache["x_prev"], x[:, -1])
    return out


def rwkv6_cache_init(cfg: ArchConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16, *,
                     device: torch.device, lead: Tuple[int, ...] = ()):
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    return {"state": _zeros(lead + (batch, H, hd, hd), torch.float32,
                            device),
            "x_prev": _zeros(lead + (batch, cfg.d_model), dtype, device)}


# ---------------------------------------------------------------------------
# RWKV channel-mix (the Finch FFN)
# ---------------------------------------------------------------------------
def rwkv_cm_init(gen: torch.Generator, cfg: ArchConfig, *,
                 lead: Tuple[int, ...] = ()):
    D, Fd = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {"w_k": dense_init(gen, D, Fd, lead=lead),
            "w_v": dense_init(gen, Fd, D, lead=lead),
            "w_r": dense_init(gen, D, D, lead=lead),
            "mu_k": torch.full(lead + (D,), 0.5, dtype=torch.float32,
                               device=dev),
            "mu_r": torch.full(lead + (D,), 0.5, dtype=torch.float32,
                               device=dev)}


def rwkv_cm_specs(cfg: ArchConfig):
    """The reference's specs for :func:`rwkv_cm_init`'s leaves."""
    return {"w_k": dense_specs(),
            "w_v": dense_specs(in_axis=TENSOR, out_axis=FSDP),
            "w_r": dense_specs(out_axis=None),
            "mu_k": spec(None), "mu_r": spec(None)}


def rwkv_cm_apply(p, cfg: ArchConfig, x: torch.Tensor, *,
                  cache: Optional[Dict[str, Any]] = None,
                  mode: str = "train") -> torch.Tensor:
    """The channel mix.  Returns y; in prefill and decode mode ``cache``
    (``{"x_prev"}``) is updated in place."""
    xp = _token_shift(x, cache["x_prev"] if cache is not None else None)
    delta = (xp - x).float()
    xf = x.float()
    xk = (xf + delta * p["mu_k"]).to(x.dtype)
    xr = (xf + delta * p["mu_r"]).to(x.dtype)
    kk = torch.square(torch.relu(dense(p["w_k"], xk)))
    out = torch.sigmoid(dense(p["w_r"], xr).float()).to(x.dtype) \
        * dense(p["w_v"], kk)
    if mode != "train":
        write_into(cache["x_prev"], x[:, -1])
    return out


def rwkv_cm_cache_init(cfg: ArchConfig, batch: int,
                       dtype: torch.dtype = torch.bfloat16, *,
                       device: torch.device, lead: Tuple[int, ...] = ()):
    return {"x_prev": _zeros(lead + (batch, cfg.d_model), dtype, device)}
