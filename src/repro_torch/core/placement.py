"""Shard placement layer (DESIGN.md §18) — where do the K shards live?

The port of ``repro.core.placement``.  Every sharded structure stacks its
K shards on a leading axis (``ShardedBatchedPQ``'s (K, capacity) heap
stack, ``ShardedMap``'s (K, capacity + 1) tables).  A *placement* decides
where that axis lives:

* :class:`StackedPlacement` — all K shard rows in one process's tensors,
  the layout of every structure that takes no placement.  ``put`` and
  ``gather`` are identities and its collectives (:data:`STACKED`) return
  their argument, so the passes run exactly the stacked code.
* :class:`MeshPlacement` — the K rows split across the ranks of a 1-D
  ``("shard",)`` :class:`~torch.distributed.device_mesh.DeviceMesh`
  (``D`` ranks, ``K % D == 0``, ``K / D`` rows a rank), one rank a
  device.  Rank ``d`` of the mesh owns global shards ``d·K_local …
  d·K_local + K_local − 1``, so an all-gather of a ``(K_local, …)`` block
  gives the stacked ``(K, …)`` order exactly, and the stacked reduction
  code then runs on identical tensors (bit-equal results).

The contract is SPMD, the multi-process form of the reference's
``shard_map``: every rank of the mesh builds the same structure and calls
it with the same arguments.  Routing, the occupancy mirror and the
cross-shard reductions run replicated on every rank; only the per-shard
phases run on the rank's own rows.  Each placed structure takes its own
process group (:meth:`MeshPlacement.comm`), so two structures' collectives
never interleave (the serving layer's combiner and device threads issue
them at the same time).  A CUDA mesh talks NCCL, a CPU mesh gloo; nothing
falls back from one to the other.

Placements are frozen, hashable dataclasses, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch


class _StackedComm:
    """The stacked placement's collectives: identities over one process,
    so a pass written against a comm runs the stacked code unchanged."""

    index = 0
    n = 1

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def min(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def close(self) -> None:
        """Nothing to release."""


STACKED = _StackedComm()


class MeshComm:
    """One placed structure's collectives over its own process group.

    ``index`` is this rank's position ``d`` in the mesh, ``n`` the mesh
    size ``D``.  :meth:`gather` concatenates every rank's block on dim 0
    in mesh order; :meth:`sum` and :meth:`min` all-reduce.  Nothing here
    reads a tensor on the host: on the card the collectives are enqueued
    on NCCL's stream, which the current stream then waits for."""

    def __init__(self, placement: "MeshPlacement", group=None):
        import torch.distributed as dist

        self._dist = dist
        self.n = placement.n_devices
        self.index = placement.index
        self._owns_group = group is None
        self.group = group if group is not None else placement.new_group()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        src = t.contiguous()
        wire = src.to(torch.uint8) if src.dtype == torch.bool else src
        parts = [torch.empty_like(wire) for _ in range(self.n)]
        self._dist.all_gather(parts, wire, group=self.group)
        out = torch.cat(parts, 0)
        return out.bool() if src.dtype == torch.bool else out

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        out = t.reshape(-1).clone()        # a 0-d tensor rides as (1,)
        self._dist.all_reduce(out, op=op, group=self.group)
        return out.reshape(t.shape)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, self._dist.ReduceOp.SUM)

    def min(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, self._dist.ReduceOp.MIN)

    def close(self) -> None:
        """Destroy the group this comm started (every rank of the mesh
        calls it, once; the mesh's own group is left alone)."""
        if self._owns_group and self.group is not None:
            if self._dist.is_initialized():
                self._dist.destroy_process_group(self.group)
            self.group = None


def _leaves_map(fn, tree):
    """``fn`` over the leaves of a tensor / array / (named) tuple tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_leaves_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_leaves_map(fn, x) for x in tree)
    return fn(tree)


@dataclass(frozen=True)
class StackedPlacement:
    """All K shard rows in one process (the default layout).

    The identity placement: ``put`` and ``gather`` return their argument
    and :meth:`comm` the identity collectives — this class exists so "no
    placement given" is a value the registry, scheduler and tests can
    name and compare against."""

    is_mesh = False

    @property
    def n_devices(self) -> int:
        return 1

    @property
    def device(self) -> Optional[torch.device]:
        return None

    def validate(self, n_shards: int) -> None:
        """Any K stacks in one process."""

    def put(self, tree, n_shards: Optional[int] = None):
        return tree

    def gather(self, tree, comm=None):
        return tree

    def comm(self, own_group: bool = True) -> _StackedComm:
        return STACKED

    def describe(self) -> str:
        return "stacked"


@dataclass(frozen=True)
class MeshPlacement:
    """K shard rows split across ``mesh``'s ``axis`` ranks.

    ``mesh`` is a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh`
    — build one with :func:`repro_torch.launch.mesh.make_combining_mesh`.
    Only the ranks of the mesh build a structure on it."""

    mesh: Any
    axis: str = "shard"

    def __post_init__(self):
        names = tuple(self.mesh.mesh_dim_names or ())
        if self.axis not in names:
            raise ValueError(f"mesh has axes {names}, no {self.axis!r}")
        if self.mesh.ndim != 1:
            raise ValueError(
                f"a combining mesh is 1-D; this one has axes {names}")

    is_mesh = True

    @property
    def n_devices(self) -> int:
        return int(self.mesh.shape[0])

    @property
    def ranks(self) -> List[int]:
        return [int(r) for r in self.mesh.mesh.tolist()]

    @property
    def index(self) -> int:
        """This rank's position d in the mesh (it owns rows d·K/D …)."""
        import torch.distributed as dist

        rank = dist.get_rank()
        if rank not in self.ranks:
            raise ValueError(
                f"rank {rank} holds no shard row: the mesh is ranks "
                f"{self.ranks}")
        return self.ranks.index(rank)

    @property
    def device(self) -> torch.device:
        """The device of this rank's rows: the current CUDA device on a
        CUDA mesh (one rank a card), else the CPU."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def validate(self, n_shards: int) -> None:
        d = self.n_devices
        if n_shards % d:
            raise ValueError(
                f"n_shards={n_shards} must be divisible by the mesh's "
                f"{self.axis!r} size {d} (every device holds K/D shard "
                f"rows)")

    def put(self, tree, n_shards: int):
        """This rank's rows ``d·K/D … (d+1)·K/D − 1`` of every leading-K
        leaf (numpy arrays or tensors, sliced where they lie)."""
        k_local = n_shards // self.n_devices
        rows = slice(self.index * k_local, (self.index + 1) * k_local)
        return _leaves_map(lambda x: x[rows], tree)

    def gather(self, tree, comm: Optional[MeshComm] = None):
        """The global (K, …) leaves: a collective every rank of the mesh
        calls (over ``comm``'s group, default the mesh's own)."""
        comm = comm if comm is not None else self.comm(own_group=False)
        return _leaves_map(comm.gather, tree)

    def new_group(self):
        """A process group over the mesh's ranks (NCCL on a CUDA mesh,
        gloo on a CPU one).  Every rank of the default group calls it, in
        the same order; a rank outside the mesh is refused after."""
        import torch.distributed as dist

        backend = "nccl" if self.mesh.device_type == "cuda" else "gloo"
        group = dist.new_group(self.ranks, backend=backend)
        self.index                   # a rank outside the mesh raises here
        return group

    def comm(self, own_group: bool = True) -> MeshComm:
        """The collectives of one placed structure: over a new group of
        its own (``own_group``), else over the mesh's group."""
        if own_group:
            return MeshComm(self)
        return MeshComm(self, group=self.mesh.get_group(self.axis))

    def describe(self) -> str:
        return f"mesh(D={self.n_devices}, axis={self.axis!r})"


def resolve_placement(placement):
    """``None`` → :class:`StackedPlacement`; placements pass through;
    anything else raises ``TypeError``."""
    if placement is None:
        return StackedPlacement()
    if not isinstance(placement, (StackedPlacement, MeshPlacement)):
        raise TypeError(f"not a placement: {placement!r}")
    return placement


def as_static(placement) -> Optional[MeshPlacement]:
    """``None`` for the stacked layout and the :class:`MeshPlacement`
    itself otherwise (the reference's static jit argument; here the
    switch between the stacked passes and their mesh twins)."""
    p = resolve_placement(placement)
    return p if p.is_mesh else None


def placed_device(placement, device):
    """The device a placed structure lives on: the mesh rank's device, or
    ``device`` when stacked (``None`` there means the card, as
    everywhere in the port).  A ``device`` that disagrees with the mesh
    raises."""
    from .batched_pq import resolve_device

    if not placement.is_mesh:
        return resolve_device(device)
    dev = placement.device
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(
            f"device={device!r} disagrees with the mesh's "
            f"{placement.mesh.device_type!r} ranks")
    return dev


def require_one_rank(placement, what: str) -> None:
    """A threaded front end combines on one rank only: under a mesh of
    D > 1 each rank's combiner would form different batches (ROADMAP
    A24)."""
    p = resolve_placement(placement)
    if p.is_mesh and p.n_devices > 1:
        raise NotImplementedError(
            f"{what} over a mesh of {p.n_devices} ranks: each rank's "
            f"combiner would form different batches; one rank combining "
            f"and the others following its dispatches is ROADMAP A24")
