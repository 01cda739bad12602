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

**Gradients.**  On CUDA tensors both scans are ``torch.autograd.Function``s
whose backward is a hand-written kernel too (``csrc/rwkv6_scan_bwd.cu``,
``csrc/rglru_scan_bwd.cu``): :func:`rwkv6_scan_bwd` and
:func:`rglru_scan_bwd`, counted in ``rwkv6_scan_bwd.launches`` and
``rglru_scan_bwd.launches``.  The reference's Pallas kernels have no
backward; its trainer differentiates the models' own scans.  Each
backward has a plain version beside it (``*_bwd_plain``, a step-by-step
reverse recurrence), which the tests and ``chip_smoke.py`` hold the
kernels to; on CPU tensors the forwards' plain versions are differentiated
by autograd.  The Functions take bf16 or f32 inputs as the forwards do and
return each gradient in its input's dtype, accumulated in f32.  A forward
that ``torch.utils.checkpoint`` runs again in the backward pass (the
models' ``remat``) launches, and counts, again.

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

from .. import _build, _sharded

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


# rwkv6_scan_bwd.cu's kT: steps between the saved states, a chunk whose
# recomputed states stay on chip (tests/test_torch_scan_grads.py holds the
# two equal)
BWD_CHUNK = 16


def rwkv6_scan_bwd_scratch_bytes(B: int, S: int, H: int) -> int:
    """Bytes of device scratch :func:`rwkv6_scan_bwd` allocates at (B, S,
    H): the f32 ``MAX_HEAD`` x ``MAX_HEAD`` state of each (batch, head)
    saved before every ``BWD_CHUNK``-step chunk but the last (0 when S
    fits one chunk)."""
    return 4 * B * H * MAX_HEAD ** 2 * max(-(-S // BWD_CHUNK) - 1, 0)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or as it is in f64 (a reference run at double
    precision, for the checks' noise floors)."""
    return t if t.dtype == torch.float64 else t.float()


def _rwkv6_step(state, w, k, v):
    """``S = w∘S + k⊗v``: the product, the outer product and the sum as
    three rounded operations, as ``rwkv6_scan_bwd.cu`` writes them."""
    return w[..., None] * state + k[..., None] * v[..., None, :]


def rwkv6_scan_bwd_plain(r, k, v, w, u, state0, dy, dsT=None, *,
                         chunk: int = BWD_CHUNK):
    """The gradients of :func:`rwkv6_scan` given ``dy`` (B, S, H, hd) and
    ``dsT`` (B, H, hd, hd; None is zeros), in f32 (f64 from f64 inputs):
    (dr, dk, dv, dw, du, dstate0).  A reverse sweep over t with dS (hd x hd) the gradient of
    S_t, S_{t-1} recomputed from the state saved every ``chunk`` steps
    (never recovered by dividing by w, which may be 0):

    - ``G = dS_t + (r_t∘u)⊗dy_t``, the gradient of the step's ``k_t⊗v_t``;
    - ``dr_t = (S_{t-1} + u∘k_t⊗v_t)·dy_t``, ``dk_t = G·v_t``,
      ``dv_t = Gᵀ·k_t``, ``dw_t[i] = Σ_j dS_t[i,j] S_{t-1}[i,j]``;
    - ``du += r_t∘k_t (v_t·dy_t)``, over time, then over the batch;
    - ``dS_{t-1} = w_t∘dS_t + r_t⊗dy_t``; the last is ``dstate0``."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf, dyf, uf = (_f32(t) for t in (r, k, v, w, dy, u))
    dt, dev = rf.dtype, r.device
    dS = (torch.zeros((B, H, hd, hd), dtype=dt, device=dev)
          if dsT is None else _f32(dsT).clone())
    state = _f32(state0)
    saved = []
    for t in range(S):
        if t % chunk == 0:
            saved.append(state)
        state = _rwkv6_step(state, wf[:, t], kf[:, t], vf[:, t])
    dr, dk, dv, dw = (torch.empty((B, S, H, hd), dtype=dt, device=dev)
                      for _ in range(4))
    du = torch.zeros((B, H, hd), dtype=dt, device=dev)
    for c in reversed(range(len(saved))):
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        states = [saved[c]]                    # S_{t-1} for t in [t0, t1)
        for t in range(t0, t1 - 1):
            states.append(_rwkv6_step(states[-1], wf[:, t], kf[:, t],
                                      vf[:, t]))
        for t in reversed(range(t0, t1)):
            sp = states[t - t0]
            rt, kt, vt, wt, dyt = (x[:, t] for x in (rf, kf, vf, wf, dyf))
            vdy = (vt * dyt).sum(-1, keepdim=True)
            g = dS + (rt * uf)[..., None] * dyt[..., None, :]
            kv = (uf * kt)[..., None] * vt[..., None, :]
            dr[:, t] = ((sp + kv) * dyt[..., None, :]).sum(-1)
            dk[:, t] = (g * vt[..., None, :]).sum(-1)
            dv[:, t] = (g * kt[..., None]).sum(-2)
            dw[:, t] = (dS * sp).sum(-1)
            du += rt * kt * vdy
            dS = wt[..., None] * dS + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.sum(0), dS


def rglru_scan_bwd_plain(a, h0, hs, dhs, dhT=None):
    """The gradients of :func:`rglru_scan` given ``hs`` (its output),
    ``dhs`` (B, S, R) and ``dhT`` (B, R; None is zeros), in f32 (f64 from
    f64 inputs): (da, db, dh0).  With ``g_{S-1} = dhs_{S-1} + dhT`` and ``g_t = dhs_t +
    a_{t+1}·g_{t+1}``: ``db_t = g_t``, ``da_t = g_t·h_{t-1}`` (``h_{-1}``
    = h0) and ``dh0 = a_0·g_0``; each sum and product one rounded
    operation, as ``rglru_scan_bwd.cu``'s ``__fadd_rn`` / ``__fmul_rn``,
    so the two are bit-equal."""
    af, dhf = _f32(a), _f32(dhs)
    hp = torch.cat([_f32(h0)[:, None], _f32(hs)[:, :-1]], dim=1)
    g = (torch.zeros_like(af[:, 0]) if dhT is None else _f32(dhT).clone())
    da, db = torch.empty_like(af), torch.empty_like(af)
    for t in reversed(range(af.shape[1])):
        g = g + dhf[:, t]
        db[:, t] = g
        da[:, t] = g * hp[:, t]
        g = af[:, t] * g
    return da, db, g


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
    version's.  On DTensors: the same, on each rank's local (batch, head)
    shards (``kernels/_sharded.py``); on fake tensors, results of the
    right shapes and nothing run."""
    if _sharded.is_dtensor(r):
        B, S, H, hd = r.shape
        x4 = {"batch": 0, "head": 2}
        st = {"batch": 0, "head": 1}
        return _sharded.local_call(
            lambda *a: rwkv6_scan(*a, chunk=chunk), (r, k, v, w, u, state0),
            (x4, x4, x4, x4, {"head": 0}, st), (x4, st),
            ((B, S, H, hd), (B, H, hd, hd)))
    if _sharded.is_fake(r):
        return _FakeScan.apply(("rwkv6", r.shape), r, k, v, w, u, state0)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, state0, chunk=chunk)
    body = "step" if r.shape[1] < SHORT_SEQ else "chunk"
    y, sT = _RWKV6Scan.apply(r, k, v, w, u, state0, body)
    if r.shape[0] * r.shape[2]:        # no launch for an empty grid
        rwkv6_scan.launches += 1
    return y, sT


class _RWKV6Scan(torch.autograd.Function):
    """:func:`rwkv6_scan` on the card, its backward the
    :func:`rwkv6_scan_bwd` kernel."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0, body):
        ctx.save_for_backward(r, k, v, w, u, state0)
        return rwkv6_scan_body(body, r, k, v, w, u, state0)

    @staticmethod
    def backward(ctx, dy, dsT):
        ins = ctx.saved_tensors
        grads = rwkv6_scan_bwd(*ins, dy, dsT)
        return (*(g.to(x.dtype) for g, x in zip(grads, ins)), None)


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
    4 bytes at a time: :func:`rglru_rows_aligned`).  On DTensors: the same,
    on each rank's local (batch, channel) shards; on fake tensors, results
    of the right shapes and nothing run."""
    if _sharded.is_dtensor(a):
        B, S, R = a.shape
        x3, x2 = {"batch": 0, "chan": 2}, {"batch": 0, "chan": 1}
        return _sharded.local_call(
            lambda *t: rglru_scan(*t, chunk=chunk, block_r=block_r),
            (a, b, h0), (x3, x3, x2), (x3, x2), ((B, S, R), (B, R)))
    if _sharded.is_fake(a):
        return _FakeScan.apply(("rglru", a.shape), a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0, chunk=chunk, block_r=block_r)
    return _RGLRUScan.apply(a, b, h0)


class _FakeScan(torch.autograd.Function):
    """Either scan on fake tensors (the dry run): f32 results of the
    scan's shapes, gradients of the inputs' shapes, nothing computed.
    The backward allocates what the card's does — f32 gradients,
    ``rwkv6_scan_bwd``'s saved-state scratch while they live, then the
    casts to the inputs' dtypes — so the dry run's step peak counts it."""

    @staticmethod
    def forward(ctx, what, *ins):
        kind, shape = what
        ctx.ins = [(t.shape, t.dtype) for t in ins]
        ctx.scratch = 0
        dev = ins[0].device
        if kind == "rwkv6":
            B, S, H, hd = shape
            outs = ((B, S, H, hd), (B, H, hd, hd))
            ctx.scratch = rwkv6_scan_bwd_scratch_bytes(B, S, H)
        else:
            B, S, R = shape
            outs = ((B, S, R), (B, R))
        return tuple(torch.empty(s, dtype=torch.float32, device=dev)
                     for s in outs)

    @staticmethod
    def backward(ctx, *grads):
        dev = grads[0].device
        f32 = [torch.empty(s, dtype=torch.float32, device=dev)
               for s, _ in ctx.ins]
        scratch = torch.empty(ctx.scratch, dtype=torch.uint8, device=dev)
        del scratch
        return (None, *(g.to(d) for g, (_, d) in zip(f32, ctx.ins)))


class _RGLRUScan(torch.autograd.Function):
    """:func:`rglru_scan` on the card, its backward the
    :func:`rglru_scan_bwd` kernel."""

    @staticmethod
    def forward(ctx, a, b, h0):
        hs, hT = _rglru_launch(a, b, h0)
        ctx.save_for_backward(a, h0, hs)
        ctx.b_dtype = b.dtype
        return hs, hT

    @staticmethod
    def backward(ctx, dhs, dhT):
        a, h0, hs = ctx.saved_tensors
        da, db, dh0 = rglru_scan_bwd(a, h0, hs, dhs, dhT)
        return da.to(a.dtype), db.to(ctx.b_dtype), dh0.to(h0.dtype)


def _rglru_launch(a, b, h0):
    """One ``rglru_scan`` launch on CUDA tensors, counted."""
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


def _bwd_input(t: torch.Tensor, name: str, shape, dev) -> torch.Tensor:
    """``t`` as a contiguous f32 tensor of ``shape`` on ``dev``."""
    if t.device != dev or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be a {tuple(shape)} tensor on {dev}, "
                         f"got {tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def rwkv6_scan_bwd(r, k, v, w, u, state0, dy, dsT=None):
    """The gradients of :func:`rwkv6_scan` (arguments and results as
    :func:`rwkv6_scan_bwd_plain`).  On CUDA tensors: one launch of the
    cluster kernel ``csrc/rwkv6_scan_bwd.cu`` on the current stream, a
    cluster of CTAs a (batch, head), each CTA a group of the state's rows,
    sweeping the sequence twice — forward, saving the state before every
    ``BWD_CHUNK``-step chunk, then backward a chunk at a time, its states
    recomputed from the saved one on chip (shared memory and registers) —
    with the saved states' scratch allocated here
    (:func:`rwkv6_scan_bwd_scratch_bytes`).
    r, k and v of one dtype (f32 or bf16) read through their strides like
    the forward's; the rest cast to f32.  A launch the card refuses (a
    cluster it cannot place) raises."""
    if r.device.type == "cpu":
        return rwkv6_scan_bwd_plain(r, k, v, w, u, state0, dy, dsT)
    dev = _on_card(r)
    B, S, H, hd = r.shape
    shape = (B, S, H, hd)
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or tuple(t.shape) != shape or t.dtype != r.dtype:
            raise ValueError(f"{name} must be a {shape} {r.dtype} tensor on "
                             f"{dev}")
    if r.dtype not in _DTYPES:
        raise ValueError(f"r, k and v must be float32 or bfloat16, got "
                         f"{r.dtype}")
    if not 0 < hd <= MAX_HEAD:
        raise ValueError(f"rwkv6_scan_bwd takes head dims up to {MAX_HEAD},"
                         f" got {hd}")
    w = _bwd_input(w, "w", shape, dev)
    dy = _bwd_input(dy, "dy", shape, dev)
    u = _bwd_input(u, "u", (H, hd), dev)
    s0 = _bwd_input(state0, "state0", (B, H, hd, hd), dev)
    dsT = (torch.zeros_like(s0) if dsT is None
           else _bwd_input(dsT, "dsT", (B, H, hd, hd), dev))
    grads = [torch.empty(shape, dtype=torch.float32, device=dev)
             for _ in range(4)]
    du = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    if B * H == 0:
        return (*grads, du.sum(0), ds0)
    saved = torch.empty(rwkv6_scan_bwd_scratch_bytes(B, S, H) // 4,
                        dtype=torch.float32, device=dev)
    rc = _build.library().rwkv6_scan_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), dy.data_ptr(), dsT.data_ptr(),
        *(g.data_ptr() for g in grads), du.data_ptr(), ds0.data_ptr(),
        saved.data_ptr(), saved.numel(), B, S, H, hd,
        *_strides(r, "r", 3), *_strides(k, "k", 3), *_strides(v, "v", 3),
        _DTYPES[r.dtype], _build.stream(dev))
    _build.check(rc, "rwkv6_scan_bwd")
    rwkv6_scan_bwd.launches += 1
    return (*grads, du.sum(0), ds0)


def rglru_scan_bwd(a, h0, hs, dhs, dhT=None):
    """The gradients of :func:`rglru_scan` (arguments and results as
    :func:`rglru_scan_bwd_plain`).  On CUDA tensors: one launch of
    ``csrc/rglru_scan_bwd.cu`` on the current stream — the forward's ring
    run in descending t: a producer warp streams a, dhs and h_{t-1} into
    shared-memory stages on mbarriers, one lane a channel runs the chain,
    a storer warp writes da and db back — bit-equal to the plain version;
    the inputs cast to contiguous f32."""
    if a.device.type == "cpu":
        return rglru_scan_bwd_plain(a, h0, hs, dhs, dhT)
    dev = _on_card(a)
    B, S, R = a.shape
    a = _bwd_input(a, "a", (B, S, R), dev)
    hs = _bwd_input(hs, "hs", (B, S, R), dev)
    dhs = _bwd_input(dhs, "dhs", (B, S, R), dev)
    h0 = _bwd_input(h0, "h0", (B, R), dev)
    dhT = (torch.zeros_like(h0) if dhT is None
           else _bwd_input(dhT, "dhT", (B, R), dev))
    da = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    db = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, R), dtype=torch.float32, device=dev)
    if B * R == 0:
        return da, db, dh0
    rc = _build.library().rglru_scan_bwd_launch(
        a.data_ptr(), h0.data_ptr(), hs.data_ptr(), dhs.data_ptr(),
        dhT.data_ptr(), da.data_ptr(), db.data_ptr(), dh0.data_ptr(), B, S,
        R, _build.stream(dev))
    _build.check(rc, "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
    return da, db, dh0


rwkv6_scan.launches = 0
rglru_scan.launches = 0
rwkv6_scan_bwd.launches = 0
rglru_scan_bwd.launches = 0

__all__ = ["rwkv6_scan", "rwkv6_scan_plain", "rwkv6_scan_body",
           "rglru_scan", "rglru_scan_plain", "rglru_rows_aligned",
           "rwkv6_scan_bwd", "rwkv6_scan_bwd_plain", "rglru_scan_bwd",
           "rglru_scan_bwd_plain", "rwkv6_scan_bwd_scratch_bytes",
           "BWD_CHUNK",
           "MAX_HEAD", "SHORT_SEQ", "RGLRU_CHANNELS", "RGLRU_STEPS",
           "RGLRU_STAGES", "RGLRU_ALIGN_BYTES"]
