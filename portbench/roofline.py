"""Peaks of one NVIDIA H100 SXM and the least time of the hand-written
kernels, from their shapes.

Published dense peaks (NVIDIA's data sheet, at the full 700 W limit).
A kernel's bound is the larger of the bytes it must move (each input
read once, each output written once) over the memory bandwidth and its
operations over the rate of the units that can do them; the same work
whatever implements it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
F32_OPS_PER_S = 67e12

# operations a state element a step (the decay multiply-add w*S + k(x)v
# and r.S); the backward's count follows rwkv6_scan_bwd.cu's sweep
RWKV6_FWD_OPS = 5
RWKV6_BWD_OPS = 18


def rwkv6_scan_bound_s(B: int, S: int, H: int, hd: int,
                       itemsize: int = 2) -> float:
    """The forward scan: r, k, v of ``itemsize`` bytes, w and y in f32,
    state0 and S_T (hd x hd) in f32, u in f32; its operations as 3xTF32
    matrix products (495 / 3 TFLOP/s)."""
    n = B * S * H * hd
    nbytes = 3 * itemsize * n + 8 * n + 8 * B * H * hd * hd + 4 * H * hd
    ops = RWKV6_FWD_OPS * B * S * H * hd * hd
    return max(nbytes / HBM_BYTES_PER_S, ops / (TF32_OPS_PER_S / 3))


def rwkv6_scan_bwd_bound_s(B: int, S: int, H: int, hd: int,
                           itemsize: int = 2) -> float:
    """The backward scan: r, k, v read in ``itemsize`` bytes; w and dy
    read and dr, dk, dv, dw written in f32; state0 and dS_T read and
    dstate0 written; u read and du written."""
    n = B * S * H * hd
    nbytes = (3 * itemsize * n + 24 * n + 12 * B * H * hd * hd
              + 8 * H * hd)
    ops = RWKV6_BWD_OPS * B * S * H * hd * hd
    return max(nbytes / HBM_BYTES_PER_S, ops / (TF32_OPS_PER_S / 3))
