"""Flash attention: the hand-written CUDA kernels
(``csrc/flash_attention.cu``) and their plain PyTorch version.

Blockwise online-softmax attention in the model's layout, q ``(B, Sq, H,
hd)``, k ``(B, Skv, K, hd)``, v ``(B, Skv, K, hd_v)`` → ``(B, Sq, H,
hd_v)`` in q's dtype, with GQA (head h reads KV head ``h // (H // K)``),
a causal mask, a sliding window (``k_pos > q_pos - window``), a logit
softcap ``cap·tanh(s/cap)`` applied before the mask, ``kv_len`` (the valid
KV prefix) and ``q_offset`` (the absolute position of q's first row),
with the finite ``NEG_INF = -1e30`` sentinel and the ``max(l, 1e-30)``
clamp of the reference's Pallas kernel
(``src/repro/kernels/flash_attention/kernel.py``).  The plain version's
math is f32 from f32 or bf16 inputs (p stays f32 for p·v).

:func:`flash_attention` is the one entry point; it picks its path from
q's device: a CUDA tensor launches a kernel (one launch for all batches
and heads) or raises, a CPU tensor runs :func:`flash_attention_plain`.
On the card the dtype picks the kernel: bf16 runs on the tensor cores
(``wgmma``, f32 sums, P rounded to bf16 before P·V; head widths padded to
the instance of 64, 128 or 256, multiples of 8 and 16-byte aligned
layouts only), f32 on the CUDA cores (f32 throughout, the checks' path).
``flash_attention.launches`` counts kernel launches.  ``block_q`` /
``block_k`` are the plain version's tiles (the reference wrapper's
arguments); the kernels tile by their own compile-time sizes
(``KERNEL_BLOCKS``).  Both visit KV tiles by the reference's skip
rule, so they agree to rounding wherever a row has an unmasked key.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build, _sharded

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None, cap: float = 0.0,
                          q_offset: int = 0, kv_len: Optional[int] = None,
                          block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """The kernel's function in plain PyTorch, tile by tile as the Pallas
    kernel sweeps it: q and KV zero-padded to whole tiles, KV tiles skipped
    by the reference's rule, an online softmax carried over each q tile's
    KV sweep.  GQA by a (K, G) split of the heads, no replication."""
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    hd_v = v.shape[-1]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    kv_len = Skv if kv_len is None else kv_len
    block_q = min(block_q, max(Sq, 1))
    block_k = min(block_k, max(Skv, 1))
    pad_q = (-Sq) % block_q
    pad_k = (-Skv) % block_k
    nq, nk = (Sq + pad_q) // block_q, (Skv + pad_k) // block_k
    dev = q.device
    # (B, K, G, S, hd) queries; (B, K, S, hd) keys and values
    qf = F.pad(q.float(), (0, 0, 0, 0, 0, pad_q))
    qf = qf.reshape(B, Sq + pad_q, K, G, hd).permute(0, 2, 3, 1, 4)
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad_k)).permute(0, 2, 1, 3)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad_k)).permute(0, 2, 1, 3)
    out = torch.empty((B, K, G, Sq + pad_q, hd_v), dtype=torch.float32,
                      device=dev)
    ar_q = torch.arange(block_q, device=dev)
    ar_k = torch.arange(block_k, device=dev)
    for i in range(nq):
        q_lo = i * block_q + q_offset
        qi = qf[:, :, :, i * block_q:(i + 1) * block_q]
        q_pos = (q_lo + ar_q)[:, None]
        m = torch.full((B, K, G, block_q), NEG_INF, device=dev)
        l = torch.zeros((B, K, G, block_q), device=dev)
        acc = torch.zeros((B, K, G, block_q, hd_v), device=dev)
        for j in range(nk):
            k_lo = j * block_k
            if causal and k_lo > q_lo + block_q - 1:
                break                         # fully above the diagonal
            if window and k_lo + block_k - 1 < q_lo - window + 1:
                continue                      # fully left of the window
            kj = kf[:, :, k_lo:k_lo + block_k]
            vj = vf[:, :, k_lo:k_lo + block_k]
            s = torch.einsum("bkgqh,bkch->bkgqc", qi, kj) * scale
            if cap:
                s = cap * torch.tanh(s / cap)
            k_pos = (k_lo + ar_k)[None, :]
            mask = k_pos < kv_len
            if causal:
                mask = mask & (k_pos <= q_pos)
            if window:
                mask = mask & (k_pos > q_pos - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkch->bkgqh", p, vj)
            m = m_new
        out[:, :, :, i * block_q:(i + 1) * block_q] = \
            acc / torch.clamp(l, min=1e-30)[..., None]
    o = out[:, :, :, :Sq].permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd_v)
    return o.to(q.dtype)


MAX_HEAD = 256                 # the kernel's widest hd and hd_v
# (query rows a CTA, KV slots a tile) of each dtype's kernel: the plain
# version tiled alike visits the same KV tiles
KERNEL_BLOCKS = {torch.float32: (64, 64), torch.bfloat16: (128, 64)}


def _strides(t: torch.Tensor, name: str) -> Tuple[int, int, int]:
    if t.stride(3) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")
    if t.dtype == torch.bfloat16:
        # the bf16 kernel moves 16-byte chunks (cp.async): 8 elements
        bad = [d for d in range(3) if t.shape[d] > 1 and t.stride(d) % 8]
        if t.data_ptr() % 16 or bad:
            raise ValueError(
                f"{name}: the bfloat16 kernel needs a 16-byte aligned base "
                f"and strides of a multiple of 8 elements, got address "
                f"{t.data_ptr():#x} and strides {tuple(t.stride())}")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, cap: float = 0.0,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Flash attention in model layout (arguments as
    :func:`flash_attention_plain`).  On CUDA tensors: one kernel launch on
    the current stream, no host sync; q, k and v of one dtype (f32 or
    bf16), each contiguous in its last dim (other strides are taken as
    they are), ``hd`` and ``hd_v`` at most 256.  In bf16 the head widths
    are multiples of 8 and each base pointer and stride 16-byte aligned;
    any other layout raises ``ValueError`` (no other path takes it).

    It has no backward, as the reference's Pallas kernel has none: on
    either device, a call while autograd records and q, k or v requires
    grad raises ``RuntimeError`` instead of returning a result whose
    gradient would be cut (training runs ``attention_impl="xla_chunked"``,
    as the reference's trainer does).

    On DTensors: the same, on each rank's local (batch, q-head) shards
    (``kernels/_sharded.py``'s ``attention_call``); on fake tensors, a
    result of the right shape and nothing run."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward (the reference's Pallas kernel "
            "has none; ROADMAP D1c): train with "
            "attention_impl='xla_chunked', or call it under torch.no_grad()")
    kw = dict(causal=causal, window=window, scale=scale, cap=cap,
              q_offset=q_offset, kv_len=kv_len, block_q=block_q,
              block_k=block_k)
    if _sharded.is_dtensor(q):
        return _sharded.attention_call(flash_attention, q, k, v, **kw)
    if _sharded.is_fake(q):
        return q.new_empty(q.shape[:3] + v.shape[3:])
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, scale=scale, cap=cap,
            q_offset=q_offset, kv_len=kv_len, block_q=block_q,
            block_k=block_k)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {dev}")
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    hd_v = v.shape[-1]
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if (tuple(k.shape) != (B, Skv, K, hd)
            or tuple(v.shape) != (B, Skv, K, hd_v) or K == 0 or H % K):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, Sq, H, hd), "
                         f"(B, Skv, K, hd), (B, Skv, K, hd_v) with K | H")
    if (not (0 < hd <= MAX_HEAD and 0 < hd_v <= MAX_HEAD)
            or q.dtype == torch.bfloat16 and (hd % 8 or hd_v % 8)):
        raise ValueError(
            f"flash_attention takes head dims up to {MAX_HEAD} (in "
            f"bfloat16, multiples of 8), got {hd} and {hd_v} in {q.dtype}")
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Skv or q_offset < 0 or window < 0:
        raise ValueError(f"need 0 <= kv_len <= Skv, q_offset >= 0 and "
                         f"window >= 0; got {kv_len}, {q_offset}, {window}")
    o = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=dev)
    if o.numel() == 0:
        return o
    scale = hd ** -0.5 if scale is None else scale
    rc = _build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, K,
        Sq, Skv, hd, hd_v, *_strides(q, "q"), *_strides(k, "k"),
        *_strides(v, "v"), *_strides(o, "o"), float(scale), float(cap),
        int(bool(causal)), int(window), kv_len, int(q_offset),
        _DTYPES[q.dtype], _build.stream(dev))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

__all__ = ["KERNEL_BLOCKS", "flash_attention", "flash_attention_plain"]
