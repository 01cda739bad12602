"""Sorted merge-compact: the hand-written CUDA kernel
(``csrc/sorted_merge.cu``) and its plain PyTorch version (DESIGN.md §13).

The batched ordered map and the counting sketch store each shard as a
sorted unique-key array; one combining pass nets its batch down to a
``keep`` mask over the array (deletions) and a short sorted run of new
pairs (insertions), then rebuilds the shard with ONE merge-compact:

    out = sort(A[keep] ∪ B[:b_count])        (+inf, +inf) past the end

Both runs are sorted and share no key, so the output positions are ranks:
``ra_i = #kept-A before i + #valid-B < A_i`` and ``rb_j = j + #kept-A <
B_j``.  The merge moves f32 values without arithmetic, so the kernel, the
plain version and the numpy oracle (``ref.py``) agree bit for bit.

:func:`merge_compact_sharded` is the one entry point; it picks its path
from ``a_keys``' device: a CUDA tensor launches the kernel (all K shards
in one ordinary launch: a single-pass scan with decoupled look-back, no
grid barrier) or raises, a CPU tensor runs :func:`merge_compact_plain`.
``merge_compact_sharded.launches`` counts kernel launches.  The output is
another buffer than A (the kernel reads A while it writes): ``out=`` takes
two (K, N) tensors whose rows may be strided, e.g. the bodies of a fresh
``(K, N + 1)`` state row block, so the pass writes its next state in
place.  The kernel's look-back status words live in one scratch a CUDA
stream, zeroed once when it is made (or outgrown) and numbered by a
per-call epoch, so a call launches nothing besides the kernel.
:func:`merge_compact` is the K = 1 call.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from .. import _build
from .._common import INF


def merge_compact_plain(a_keys: torch.Tensor, a_vals: torch.Tensor,
                        a_keep: torch.Tensor, b_keys: torch.Tensor,
                        b_vals: torch.Tensor, b_count: torch.Tensor, *,
                        out: Optional[Tuple[torch.Tensor, torch.Tensor]]
                        = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch twin of the reference's ``merge_compact_xla`` over a shard
    axis (element-wise identical): broadcast-compare ranks and a
    predicated scatter whose masked lanes all write +inf to a scratch
    column.

    a_keys/a_vals: (K, N) f32; a_keep: (K, N) bool or 0/1 ints;
    b_keys/b_vals: (K, C) f32; b_count: (K,) ints.  Returns ``(m_keys,
    m_vals)`` (K, N) f32 — written into ``out`` when given."""
    K, n = a_keys.shape
    c = b_keys.shape[1]
    dev = a_keys.device
    keep = a_keep if a_keep.dtype == torch.bool else a_keep != 0
    lane = torch.arange(c, device=dev)
    b_valid = lane[None, :] < b_count.reshape(K, 1).to(lane.dtype)
    kc = keep.to(torch.int64)
    ex = torch.cumsum(kc, 1) - kc
    ra = ex + (b_valid[:, None, :]
               & (b_keys[:, None, :] < a_keys[:, :, None])).sum(2)
    rb = lane[None, :] + (keep[:, None, :]
                          & (a_keys[:, None, :] < b_keys[:, :, None])).sum(2)
    ta = torch.where(keep, ra, n).clamp(0, n)
    tb = torch.where(b_valid, rb, n).clamp(0, n)
    m_keys = torch.full((K, n + 1), INF, dtype=torch.float32, device=dev)
    m_vals = torch.full((K, n + 1), INF, dtype=torch.float32, device=dev)
    m_keys.scatter_(1, ta, torch.where(keep, a_keys, INF))
    m_vals.scatter_(1, ta, torch.where(keep, a_vals, INF))
    m_keys.scatter_(1, tb, torch.where(b_valid, b_keys, INF))
    m_vals.scatter_(1, tb, torch.where(b_valid, b_vals, INF))
    if out is None:
        return m_keys[:, :n], m_vals[:, :n]
    out[0].copy_(m_keys[:, :n])
    out[1].copy_(m_vals[:, :n])
    return out[0], out[1]


def _rows(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> int:
    """Raise unless ``t`` is a ``shape`` tensor of ``dtype`` on the CUDA
    ``device`` with unit stride along its rows; return its row stride."""
    if device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {device}")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must have unit stride along its rows")
    return t.stride(0)


_limits = {}


def _kernel_limits() -> Tuple[int, int]:
    """(A slots per tile, widest B run) as the built kernel defines them."""
    if not _limits:
        lib = _build.library()
        _limits["tile"] = lib.sorted_merge_tile()
        _limits["lanes"] = lib.sorted_merge_max_lanes()
    return _limits["tile"], _limits["lanes"]


EPOCHS = 1 << 21        # the status word's epoch field (csrc/sorted_merge.cu)
_scratch = {}           # (device index, stream) -> [int64 scratch, epoch]
_scratch_lock = threading.Lock()


def _status_scratch(dev: torch.device, stream: int, words: int):
    """The look-back scratch of ``stream`` (zeroed when it is made: at the
    first call, when a call outgrows it, and when the epochs run out) and
    this call's epoch.  Calls on one stream run in its order, so a status
    word of an earlier call never carries the epoch of a later one."""
    key = (dev.index, stream)
    s = _scratch.get(key)
    if s is None or s[0].numel() < words or s[1] + 1 >= EPOCHS:
        s = [torch.zeros(words, dtype=torch.int64, device=dev), 0]
        _scratch[key] = s
    s[1] += 1
    return s


def merge_compact_sharded(a_keys: torch.Tensor, a_vals: torch.Tensor,
                          a_keep: torch.Tensor, b_keys: torch.Tensor,
                          b_vals: torch.Tensor, b_count: torch.Tensor, *,
                          out: Optional[Tuple[torch.Tensor, torch.Tensor]]
                          = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge-compact all K shards (arguments as
    :func:`merge_compact_plain`).  On CUDA tensors: one kernel launch on
    the current stream, no host sync (``b_count`` is read on the device)
    and no other launch (the stream's look-back scratch is zeroed once,
    when first made); ``a_keep`` is bool there, and ``out`` must not
    overlap A."""
    if a_keys.device.type == "cpu":
        return merge_compact_plain(a_keys, a_vals, a_keep, b_keys, b_vals,
                                   b_count, out=out)
    dev = a_keys.device
    K, n = a_keys.shape
    c = b_keys.shape[1]
    sak = _rows(a_keys, "a_keys", torch.float32, (K, n), dev)
    sav = _rows(a_vals, "a_vals", torch.float32, (K, n), dev)
    skeep = _rows(a_keep, "a_keep", torch.bool, (K, n), dev)
    sbk = _rows(b_keys, "b_keys", torch.float32, (K, c), dev)
    sbv = _rows(b_vals, "b_vals", torch.float32, (K, c), dev)
    _build.require(b_count, "b_count", torch.int32, (K,), dev)
    if out is None:
        out = (torch.empty((K, n), dtype=torch.float32, device=dev),
               torch.empty((K, n), dtype=torch.float32, device=dev))
    sok = _rows(out[0], "out keys", torch.float32, (K, n), dev)
    sov = _rows(out[1], "out vals", torch.float32, (K, n), dev)
    if K == 0 or n == 0:
        return out
    _, lanes = _kernel_limits()
    if c > lanes:
        raise ValueError(f"sorted_merge takes at most {lanes} B lanes, "
                         f"got {c}")
    lib = _build.library()
    stream = _build.stream(dev)
    with _scratch_lock:
        scratch, epoch = _status_scratch(
            dev, stream, lib.sorted_merge_scratch_words(K, n))
        rc = lib.sorted_merge_launch(
            K, n, c, a_keys.data_ptr(), sak, a_vals.data_ptr(), sav,
            a_keep.data_ptr(), skeep, b_keys.data_ptr(), sbk,
            b_vals.data_ptr(), sbv, b_count.data_ptr(), out[0].data_ptr(),
            sok, out[1].data_ptr(), sov, scratch.data_ptr(), epoch, stream)
        if rc != 0:         # a launch that did not run leaves no state
            _scratch.pop((dev.index, stream), None)
    _build.check(rc, "sorted_merge")
    merge_compact_sharded.launches += 1
    return out


merge_compact_sharded.launches = 0


def merge_compact(a_keys: torch.Tensor, a_vals: torch.Tensor,
                  a_keep: torch.Tensor, b_keys: torch.Tensor,
                  b_vals: torch.Tensor, b_count) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """K = 1 call of :func:`merge_compact_sharded` on (N,) / (C,) runs."""
    bc = torch.as_tensor(b_count, dtype=torch.int32,
                         device=a_keys.device).reshape(1)
    mk, mv = merge_compact_sharded(a_keys[None], a_vals[None], a_keep[None],
                                   b_keys[None], b_vals[None], bc)
    return mk[0], mv[0]


__all__ = ["merge_compact", "merge_compact_plain", "merge_compact_sharded"]
