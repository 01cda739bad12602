"""Leaves of the parameter trees the port passes around: nested dicts,
tuples, lists and NamedTuples of tensors, in the reference's leaf order
(``jax.tree`` flattens a dict in sorted key order); and the few mesh
helpers shared by the optimizer, the model's vocab-parallel lookups and
the kernels' local calls."""
from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import torch


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves(tree) -> List[Any]:
    """The tensor leaves of ``tree``, dict keys sorted, as ``jax.tree``
    orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def local(t):
    """A DTensor's local shard (the tensor whose storage it holds), or
    ``t`` itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def like(t, ref, placements=None):
    """The local tensor ``t`` as a DTensor laid out as ``ref`` (of its
    global shape, on its mesh, with ``placements`` or ``ref``'s), or ``t``
    itself when ``ref`` is a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(ref, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh,
                              placements or ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def mesh_reduce(x, ref, op: str = "sum"):
    """``x``, a local () value computed from ``ref``'s shard, reduced
    (``"sum"`` or ``"max"``) over every rank of ``ref``'s mesh — a plain
    tensor, equal on every rank; ``x`` itself for a plain ``ref``."""
    from torch.distributed.tensor import DTensor, Partial

    if not isinstance(ref, DTensor):
        return x
    mesh = ref.device_mesh
    return DTensor.from_local(x.reshape(1), mesh, [Partial(op)] * mesh.ndim,
                              run_check=False).full_tensor().reshape(())


def counted_once(t) -> bool:
    """Whether this rank's shard of ``t`` is the copy a mesh-wide sum
    counts: a DTensor's shard is replicated over the mesh dims whose
    placement is ``Replicate``, and only the rank at index 0 of each of
    them counts it."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return True
    mesh = t.device_mesh
    return all(mesh.get_local_rank(md) == 0
               for md, pl in enumerate(t.placements)
               if isinstance(pl, Replicate))


def shard_index(mesh, which: Sequence[bool]) -> Tuple[int, int]:
    """(this rank's index, count) of the shards cut by the mesh dims for
    which ``which`` is true, major first (DTensor's order)."""
    idx, n = 0, 1
    for md, w in enumerate(which):
        if w:
            size = mesh.size(md)
            idx = idx * size + mesh.get_local_rank(md)
            n *= size
    return idx, n


def vocab_lookup(lookup: Callable, idx: torch.Tensor, n_local: int, mesh,
                 vocab: Sequence[bool], placements: Sequence, shape):
    """A lookup in a vocab-parallel table, written out (DTensor's own
    masked lookup loses its mask when the indices are redistributed):
    ``idx``, this rank's global vocab indices, shifted into its own
    ``n_local`` entries (the mesh dims flagged in ``vocab`` cut the vocab,
    major first); ``lookup`` of the clamped local indices, zero where an
    index falls outside them.  Returns a DTensor of global ``shape``, a
    partial sum over the vocab dims and laid out by ``placements`` over
    the others."""
    from torch.distributed.tensor import DTensor, Partial

    rows = idx - shard_index(mesh, vocab)[0] * n_local
    hit = (rows >= 0) & (rows < n_local)
    out = lookup(torch.where(hit, rows, 0))
    out = out * hit.reshape(hit.shape + (1,) * (out.dim() - hit.dim()))
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(
        out, mesh, [Partial() if v else p for v, p in zip(vocab, placements)],
        run_check=False, shape=torch.Size(shape), stride=stride)
