"""The linear recurrences of the recurrent families: the hand-written CUDA
kernels (``csrc/rwkv6_scan.cu``, ``csrc/rglru_scan.cu``) and their plain
PyTorch versions.

- :func:`rwkv6_scan` — the RWKV-6 time-mix recurrence with a matrix state
  per head and a data-dependent per-channel decay:
  ``y_t = r_t·(S_{t-1} + u∘(k_t⊗v_t))``, ``S_t = w_t∘S_{t-1} + k_t⊗v_t``.
  Inputs in the model's layout ``(B, S, H, hd)``, ``u`` ``(H, hd)``,
  ``state0`` ``(B, H, hd, hd)``; returns ``(y (B, S, H, hd) f32, S_T)``.
- :func:`rglru_scan` — the RG-LRU's diagonal recurrence
  ``h_t = a_t·h_{t-1} + b_t`` over ``(B, S, R)``, ``h0`` ``(B, R)``;
  returns ``(h (B, S, R) f32, h_T)``.

Each function is the one entry point of its kernel and picks its path
from the inputs' device: a CUDA tensor launches the kernel (one launch
for all batches, heads and channels) or raises, a CPU tensor runs the
plain version.  ``rwkv6_scan.launches`` and ``rglru_scan.launches`` count
kernel launches.

The plain versions compute what the reference's Pallas kernels compute
(``src/repro/kernels/linear_scan/kernel.py``):

- :func:`rwkv6_scan_plain` is the TPU kernel's chunked factored form,
  vectorised over (B, H), a loop over chunks of ``chunk`` tokens; a tail
  shorter than ``chunk`` is padded with decay 1.0 and zero inputs, so the
  padded steps leave the state alone (the reference wrapper's rule).  Its
  validity domain is the reference's: Σ|log w| over a chunk below ~80.
  The kernel has no such domain: below ``SHORT_SEQ`` tokens (a decode
  step) it runs the exact per-token recurrence, from ``SHORT_SEQ`` on the
  two-level chunked form on the tensor cores, whose decay factors are
  products of w over token ranges (none above 1) and whose products run
  at f32 accuracy (3xTF32; ``csrc/rwkv6_scan.cu``).  Within the plain
  version's domain the two agree to f32 rounding, not bit for bit;
  outside it the kernel is held to the exact scan (``ref.py``).
- :func:`rglru_scan_plain` is the exact step ``h = a_t·h`` then ``+ b_t``,
  two separately rounded operations, as the kernel's
  ``__fadd_rn(__fmul_rn(a, h), b)``: the two are bit-equal.  A padded
  step (a = 1, b = 0) would be the identity, so neither pads; ``chunk``
  and ``block_r`` are the reference wrapper's arguments, kept for its
  signature.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD = 64                  # the widest hd rwkv6_scan.cu is built for
SHORT_SEQ = 16                 # shorter sequences take the per-token body
# rglru_scan.cu's tile (kChannels, kSteps, kStages) and row alignment
# (kAlignBytes), mirrored for the CPU emulation of its schedule
# (tests/test_torch_rglru_redesign.py holds the two equal): a CTA owns
# RGLRU_CHANNELS channels of one batch row and streams a and b through a
# ring of RGLRU_STAGES stages of RGLRU_STEPS steps
RGLRU_CHANNELS = 32
RGLRU_STEPS = 64
RGLRU_STAGES = 6
RGLRU_ALIGN_BYTES = 16


def rglru_rows_aligned(offset: int, batch_stride: int,
                       seq_stride: int) -> bool:
    """rglru_scan.cu's ``rows_aligned``: every (batch, step) row of a
    float32 tensor at byte ``offset`` from a RGLRU_ALIGN_BYTES boundary,
    with these strides in elements, starts on RGLRU_ALIGN_BYTES, so the
    ring stages it by 16-byte copies; otherwise by 4-byte ones."""
    floats = RGLRU_ALIGN_BYTES // 4
    return (offset % RGLRU_ALIGN_BYTES == 0 and batch_stride % floats == 0
            and seq_stride % floats == 0)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
                     *, chunk: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's chunked factored RWKV-6 math in plain PyTorch
    (``_rwkv6_kernel``), chunk by chunk, all (b, h) at once: with
    ``la`` the in-chunk cumsum of log w,
    ``y = tril(q̃ k̃ᵀ, -1)·v + diag(Σ r∘u∘k)·v + q̃·S0`` and
    ``S = exp(la_T)∘S0 + (k∘exp(la_T − la))ᵀ·v``, in f32."""
    B, S, H, hd = r.shape
    state = state0.float().clone()
    if S == 0:
        return torch.zeros((B, 0, H, hd), dtype=torch.float32,
                           device=r.device), state
    T = min(chunk, S)
    pad = (-S) % T

    def bhsd(x, value=0.0):
        x = x.float().permute(0, 2, 1, 3)
        return F.pad(x, (0, 0, 0, pad), value=value) if pad else x

    rt, kt, vt = bhsd(r), bhsd(k), bhsd(v)
    wt = bhsd(w, 1.0)              # decay 1.0: padded steps keep the state
    uf = u.float()[None, :, None, :]                 # (1, H, 1, hd)
    row = torch.arange(T, device=r.device)[:, None]
    col = torch.arange(T, device=r.device)[None, :]
    y = torch.empty((B, H, S + pad, hd), dtype=torch.float32,
                    device=r.device)
    for c in range((S + pad) // T):
        sl = slice(c * T, (c + 1) * T)
        rc, kc, vc, wc = rt[:, :, sl], kt[:, :, sl], vt[:, :, sl], wt[:, :, sl]
        logw = torch.log(wc)
        la = torch.cumsum(logw, dim=2)               # la_t
        la_prev = la - logw                          # la_{t-1}
        laT = la[:, :, T - 1]                        # (B, H, hd)
        qt = rc * torch.exp(la_prev)
        kt_ = kc * torch.exp(-la)
        s = torch.where(col < row, qt @ kt_.transpose(-1, -2), 0.0)
        diag = torch.sum(rc * uf * kc, dim=-1)       # current-token bonus
        s = s + torch.where(col == row, diag[..., None], 0.0)
        y[:, :, sl] = s @ vc + qt @ state
        k_end = kc * torch.exp(laT[:, :, None, :] - la)
        state = torch.exp(laT)[..., None] * state \
            + k_end.transpose(-1, -2) @ vc
    return y[:, :, :S].permute(0, 2, 1, 3).contiguous(), state


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
                     chunk: int = 256, block_r: int = 512
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t·h_{t-1} + b_t`` in f32, one token at a time: the
    product and the sum as two rounded operations (the kernel's
    ``__fmul_rn`` then ``__fadd_rn``, no FMA)."""
    af, bf = a.float(), b.float()
    h = h0.float().clone()
    hs = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    for t in range(af.shape[1]):
        h = af[:, t] * h
        h = h + bf[:, t]
        hs[:, t] = h
    return hs, h


def _strides(t: torch.Tensor, name: str, n: int):
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")
    return t.stride()[:n]


def _on_card(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {t.device}")
    return t.device


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor, *,
               chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence (arguments as :func:`rwkv6_scan_plain`).  On CUDA
    tensors: one kernel launch on the current stream, no host sync, the
    per-token body below ``SHORT_SEQ`` tokens and the chunked body from
    there on; r, k and v of one dtype (f32 or bf16), read through their
    (batch, seq, head) strides with the last dim contiguous; w in f32
    (cast if not); ``hd`` at most ``MAX_HEAD``.  ``chunk`` is the plain
    version's."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, state0, chunk=chunk)
    body = "step" if r.shape[1] < SHORT_SEQ else "chunk"
    y, sT = rwkv6_scan_body(body, r, k, v, w, u, state0)
    if r.shape[0] * r.shape[2]:        # no launch for an empty grid
        rwkv6_scan.launches += 1
    return y, sT


def rwkv6_scan_body(body: str, r: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                    state0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of one body of ``rwkv6_scan`` on CUDA tensors, ``body``
    "step" (the exact per-token recurrence, any S) or "chunk" (the
    chunked form); counts nothing.  :func:`rwkv6_scan` picks the body;
    this is for comparing the two on the card."""
    dev = _on_card(r)
    B, S, H, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
        if tuple(t.shape) != (B, S, H, hd):
            raise ValueError(f"{name} must have shape {(B, S, H, hd)}, got "
                             f"{tuple(t.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k and v must share a dtype, float32 or "
                         f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    if not 0 < hd <= MAX_HEAD:
        raise ValueError(f"rwkv6_scan takes head dims up to {MAX_HEAD}, "
                         f"got {hd}")
    w = w.float()
    u = u.float().contiguous()
    s0 = state0.float().contiguous()
    _build.require(u, "u", torch.float32, (H, hd), dev)
    _build.require(s0, "state0", torch.float32, (B, H, hd, hd), dev)
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    sT = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    if B * H == 0:
        return y, sT
    launch = getattr(_build.library(), f"rwkv6_scan_{body}_launch")
    rc = launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), sT.data_ptr(), B, S, H, hd,
        *_strides(r, "r", 3), *_strides(k, "k", 3), *_strides(v, "v", 3),
        *_strides(w, "w", 3), _DTYPES[r.dtype], _build.stream(dev))
    _build.check(rc, f"rwkv6_scan ({body})")
    return y, sT


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
               chunk: int = 256, block_r: int = 512
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU recurrence (arguments as :func:`rglru_scan_plain`).  On CUDA
    tensors: one kernel launch on the current stream, no host sync; a and
    b in f32 (cast if not), read through their (batch, seq) strides with
    the last dim contiguous, from any base (rows off 16 bytes are staged
    4 bytes at a time: :func:`rglru_rows_aligned`)."""
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0, chunk=chunk, block_r=block_r)
    dev = _on_card(a)
    B, S, R = a.shape
    if b.device != dev or tuple(b.shape) != (B, S, R):
        raise ValueError(f"b must be a {(B, S, R)} tensor on {dev}, got "
                         f"{tuple(b.shape)} on {b.device}")
    a, b = a.float(), b.float()
    h0 = h0.float().contiguous()
    _build.require(h0, "h0", torch.float32, (B, R), dev)
    hs = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    hT = torch.empty((B, R), dtype=torch.float32, device=dev)
    if B * R == 0:
        return hs, hT
    rc = _build.library().rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
        hT.data_ptr(), B, S, R, *_strides(a, "a", 2), *_strides(b, "b", 2),
        _build.stream(dev))
    _build.check(rc, "rglru_scan")
    rglru_scan.launches += 1
    return hs, hT


rwkv6_scan.launches = 0
rglru_scan.launches = 0

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "rwkv6_scan_body",
           "rglru_scan", "rglru_scan_plain", "rglru_rows_aligned",
           "MAX_HEAD", "SHORT_SEQ", "RGLRU_CHANNELS", "RGLRU_STEPS",
           "RGLRU_STAGES", "RGLRU_ALIGN_BYTES"]
