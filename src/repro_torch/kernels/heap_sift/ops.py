"""Phase 3, the sift-down wavefront: the hand-written CUDA kernel
(``csrc/heap_sift.cu``) and its plain PyTorch version.

The wrappers pick their path from the heap's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs
:func:`sift_wavefront_plain`.  Both update the heap in place.
``sift_wavefront_sharded.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import _build
from .._common import depth, gather_masked, put, take

MAX_C = 1024        # one thread per cursor, one CTA per shard


def sift_wavefront_plain(a: torch.Tensor, size: torch.Tensor,
                         starts: torch.Tensor,
                         active: torch.Tensor) -> torch.Tensor:
    """Torch port of ``batched_pq._sift_wavefront`` over a shard axis.

    a: (K, cap) f32, updated in place and returned; size: (K,) int32;
    starts: (K, c) int32 node ids; active: (K, c) bool.  Cursors are
    staggered by start depth, deepest first (the paper's SE order).  The
    loop ends when no cursor is active, read on the host: this version is
    the CPU path and the card's yardstick, never the card's pass.
    """
    depths = depth(starts)
    d_max = torch.where(active, depths, 0).max(dim=1, keepdim=True).values
    delay = d_max - depths
    sz = size[:, None]
    pos = starts.clone()
    active = active.clone()
    step = 0
    while bool(active.any()):
        moving = active & (step >= delay)
        v = torch.where(moving, pos, 0)
        left, right = 2 * v, 2 * v + 1
        av = take(a, v)
        lv = gather_masked(a, left, moving & (left <= sz))
        rv = gather_masked(a, right, moving & (right <= sz))
        wv = torch.minimum(lv, rv)
        w = torch.where(lv <= rv, left, right)
        swap = moving & (wv < av)
        active = active & ~(moving & ~swap)
        put(a, torch.where(swap, v, 0), wv)
        put(a, torch.where(swap, w, 0), av)
        pos = torch.where(swap, w, pos)
        step += 1
    return a


def sift_wavefront_sharded(a: torch.Tensor, size: torch.Tensor,
                           starts: torch.Tensor,
                           active: torch.Tensor) -> torch.Tensor:
    """All-shards sift wavefront, one CTA per shard on the card.

    a: (K, cap) f32 heap stack, updated in place and returned; size: (K,)
    int32; starts: (K, c) int32; active: (K, c) bool.
    """
    if a.device.type == "cpu":
        return sift_wavefront_plain(a, size, starts, active)
    K, cap = a.shape
    c = starts.shape[-1]
    if not 1 <= c <= MAX_C:
        raise ValueError(f"heap_sift supports 1 <= c <= {MAX_C} cursors")
    _build.require(a, "a", torch.float32, (K, cap), a.device)
    _build.require(size, "size", torch.int32, (K,), a.device)
    _build.require(starts, "starts", torch.int32, (K, c), a.device)
    _build.require(active, "active", torch.bool, (K, c), a.device)
    rc = _build.library().heap_sift_launch(
        a.data_ptr(), size.data_ptr(), starts.data_ptr(), active.data_ptr(),
        K, cap, c, _build.stream(a.device))
    _build.check(rc, "heap_sift")
    sift_wavefront_sharded.launches += 1
    return a


sift_wavefront_sharded.launches = 0


def sift_wavefront(a: torch.Tensor, size: torch.Tensor, starts: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
    """Single-heap form: a (cap,), size () int32, starts/active (c,); the
    K = 1 launch of :func:`sift_wavefront_sharded`.  Updates ``a`` in
    place and returns it."""
    sift_wavefront_sharded(a[None], size.reshape(1), starts[None],
                           active[None])
    return a
