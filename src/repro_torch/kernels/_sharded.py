"""The kernels' entry points on DTensors: each rank runs the same kernel
(or, on CPU tensors, its plain version) on its local shards.

A kernel declares, for each argument and result, which of its tensor
dims carry the *logical* dims it is local in (``"batch"``, ``"head"``,
``"chan"``...): ``rwkv6_scan`` is local per (batch, head), ``rglru_scan``
per (batch, channel), ``flash_attention`` per (batch, q-head).  The
layout of a call is read from its leading argument: a mesh dim that
shards one of those logical dims keeps it, any other mesh dim
(replicated, partial, or sharding a dim the kernel is not local in, such
as the sequence) is gathered to ``Replicate``.  Every argument is then
redistributed to the layout's placement for its own dims — an argument
without a logical dim (``u`` has no batch) is replicated over the mesh
dims that shard it — and its gradient is declared ``Partial`` there,
since each rank's local gradient sums over its own shard only.  Plain
tensors among the arguments (zero states made inside the model) are
taken as replicated.  Results are DTensors of the layout's placements.
Nothing is guessed from shapes, and no placement outside the declared
dims reaches a kernel.

:func:`is_fake` tells the dry run's fake tensors apart: the wrappers then
return results of the right shapes without launching anything or running
a plain version's loop (``launch/dryrun.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..optim.tree import shard_index

Dims = Dict[str, int]          # logical dim name -> tensor dim


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (``FakeTensorMode``'s), which holds
    shapes and no data."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


class Layout:
    """Which logical dim each mesh dim shards in one call (``None``:
    replicated), taken from the leading argument's placements."""

    def __init__(self, lead, dims: Dims):
        from torch.distributed.tensor import Shard

        self.mesh = lead.device_mesh
        inv = {d: name for name, d in dims.items()}
        self.logical: List[Optional[str]] = []
        for md, pl in enumerate(lead.placements):
            name = inv.get(pl.dim) if isinstance(pl, Shard) else None
            if name is not None and lead.shape[pl.dim] % \
                    self.mesh.size(md):
                name = None                  # uneven: gather it
            self.logical.append(name)

    def placements(self, dims: Dims, grad: bool = False) -> list:
        """An argument's placements; ``grad``: its gradient's."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        out = []
        for name in self.logical:
            if name is None:
                out.append(Replicate())
            elif name in dims:
                out.append(Shard(dims[name]))
            else:
                out.append(Partial() if grad else Replicate())
        return out

    def coord(self, name: str) -> Tuple[int, int]:
        """(this rank's index, count) of the shards of logical dim
        ``name`` over the mesh dims that shard it, major first."""
        return shard_index(self.mesh, [ln == name for ln in self.logical])


def to_local(t, layout: Layout, dims: Dims) -> torch.Tensor:
    """``t`` (a DTensor, or a plain tensor taken as replicated)
    redistributed to ``layout``'s placement for ``dims``, as the local
    shard, its gradient declared per :meth:`Layout.placements`."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = layout.mesh
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    want = layout.placements(dims)
    if list(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t.to_local(grad_placements=layout.placements(dims, grad=True))


def from_local(t: torch.Tensor, layout: Layout, dims: Dims,
               shape: Sequence[int]):
    """The local result ``t`` as a DTensor of global ``shape``."""
    from torch.distributed.tensor import DTensor

    stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    return DTensor.from_local(t.contiguous(), layout.mesh,
                              layout.placements(dims),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def local_call(fn: Callable, args: Sequence, arg_dims: Sequence[Dims],
               out_dims: Sequence[Dims], out_shapes: Sequence[Sequence[int]]):
    """``fn`` on the local shards of ``args`` (the first a DTensor, which
    sets the layout); returns its results as DTensors of ``out_shapes``."""
    layout = Layout(args[0], arg_dims[0])
    local = [to_local(a, layout, d) for a, d in zip(args, arg_dims)]
    res = fn(*local)
    return tuple(from_local(o, layout, d, s)
                 for o, d, s in zip(res, out_dims, out_shapes))


def attention_call(fn: Callable, q, k, v, **kw):
    """``fn(q, k, v, **kw)``, an attention of the model's layout (q
    ``(B, Sq, H, hd)``, k and v ``(B, Skv, K, hd*)``, GQA head h reading
    KV head ``h // (H // K)``), on each rank's local (batch, q-head)
    shards.  Where the q heads are sharded and the KV heads divide as
    they do, K/V take the same placement; where the KV heads are fewer
    than the shards (GQA, K/V replicated over the head axis), each rank
    gives its q heads the KV heads they group with: heads ``[h0, h0 +
    Hl)`` read KV heads ``[h0 // G, (h0 + Hl - 1) // G]``, which needs
    ``Hl`` to divide ``G`` or ``G`` to divide ``Hl`` (``ValueError``
    otherwise), and the KV gradient is a partial sum over the head
    axis."""
    B, Sq, H, _ = q.shape
    K, hd_v = k.shape[2], v.shape[3]
    G = H // K
    qd = {"batch": 0, "head": 2}
    layout = Layout(q, qd)
    idx, n = layout.coord("head")
    kvd = {"batch": 0, "head": 2} if K % n == 0 else {"batch": 0}
    ql = to_local(q, layout, qd)
    kl = to_local(k, layout, kvd)
    vl = to_local(v, layout, kvd)
    if K % n:
        Hl = H // n
        if G % Hl and Hl % G:
            raise ValueError(f"{Hl} local q heads do not group with whole "
                             f"KV heads (H {H}, K {K})")
        h0 = idx * Hl
        kv = slice(h0 // G, (h0 + Hl - 1) // G + 1)
        kl, vl = kl[:, :, kv], vl[:, :, kv]
    return from_local(fn(ql, kl, vl, **kw), layout, qd, (B, Sq, H, hd_v))


__all__ = ["Layout", "attention_call", "from_local", "is_dtensor", "is_fake",
           "local_call", "to_local"]
