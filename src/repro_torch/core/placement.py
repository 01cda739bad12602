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
``shard_map``: every rank of the mesh builds the same structure and makes
the same calls on it.  Routing, the occupancy mirror and the cross-shard
reductions run replicated on every rank; only the per-shard phases run on
the rank's own rows.  Each placed structure takes its own process group
(:meth:`MeshPlacement.comm`), so two structures' collectives never
interleave (the serving layer's combiner and device threads issue them at
the same time).  A CUDA mesh talks NCCL, a CPU mesh gloo; nothing falls
back from one to the other.

**Leader and followers.**  A threaded front end (the parallel combiner,
the serving scheduler) forms its batches from the timing of its client
threads, so only one rank may form them: the mesh's index 0, the
*leader* (:attr:`MeshPlacement.is_leader`).  Beside its comm group every
placed structure holds a :class:`DispatchChannel`, a gloo group over the
same ranks.  Each call of the structure that reaches its rows (the
methods wrapped by :func:`led`) is sent on the channel as a record — the
method and its host arguments — before it runs on the leader; a
*follower* (every other rank) receives the records in order and runs the
same calls on its own rows (:meth:`DispatchChannel.follow`), so its rows
stay the stacked layout's rows for its index after every dispatch.  A
guarded dispatch's outcome rides the channel too: a follower restores
and retries exactly where the leader's fault plan failed the leader.  A
follower that calls the structure itself (SPMD) receives the leader's
record and must have made the same call, or :class:`ChannelError`
raises.  The channel runs at every mesh size, D = 1 included.

Placements are frozen, hashable dataclasses, as in the reference.
"""
from __future__ import annotations

import contextlib
import functools
import pickle
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from .faults import InjectedFault


class _StackedComm:
    """The stacked placement's collectives: identities over one process,
    so a pass written against a comm runs the stacked code unchanged."""

    index = 0
    n = 1
    channel = None

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
        # a structure's own group carries its dispatches' channel; the
        # mesh's group (own_group=False) only gathers
        self.channel = DispatchChannel(placement) if group is None else None

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
        """Close the channel and destroy the group this comm started
        (every rank of the mesh calls it, once — a follower through the
        leader's record; the mesh's own group is left alone)."""
        if self.channel is not None:
            self.channel.close()
        if self._owns_group and self.group is not None:
            if self._dist.is_initialized():
                self._dist.destroy_process_group(self.group)
            self.group = None


class ChannelError(RuntimeError):
    """The ranks of a led structure lost step: a record out of order, or
    a follower's own call that is not the leader's."""


VERDICT = "verdict"            # a guarded dispatch's outcome
REBUILD = "rebuild"            # a structure rebuilt on the same comm


def _same(a, b) -> bool:
    """Deep equality of two calls' host arguments (arrays by value)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


class DispatchChannel:
    """The leader's dispatches of one placed structure, sent to its
    followers over a gloo group of the mesh's ranks.

    A record is ``(seq, name, args, kw)``, pickled: ``name`` the
    qualified name of a :func:`led` method, or :data:`VERDICT` /
    :data:`REBUILD`.  It rides one broadcast of :attr:`HEAD` bytes (the
    length, then the bytes), and a second for what does not fit.  The
    leader's broadcasts are asynchronous: it packs and enqueues a record
    and goes on, so its pass waits for no follower and reads nothing on
    the device; the works are reaped as they complete and all waited for
    at :meth:`close`.  A follower's receive blocks, within the group's
    timeout.  ``seq`` numbers the records, so a follower that misses one
    raises :class:`ChannelError`.

    ``log``: when a list, the leader appends ``(name, args, kw)`` of
    every record it sends, and to ``send_s`` the seconds each send took
    on the host (packing and enqueueing) — what a replay and a
    measurement read."""

    HEAD = 1024

    def __init__(self, placement: "MeshPlacement"):
        import torch.distributed as dist

        self._dist = dist
        self.index = placement.index
        self.is_leader = self.index == 0
        self.leader_rank = placement.ranks[0]
        self.group = placement.new_group(backend="gloo")
        self.lock = threading.RLock()
        self._tls = threading.local()
        self._seq = 0
        self._pending: deque = deque()
        self.log: Optional[list] = None
        self.send_s: List[float] = []

    # -- the wire -----------------------------------------------------------
    def _reap(self, keep: int = 64) -> None:
        """Wait for the oldest sends (raising a failed one's error) while
        more than ``keep`` are in flight — rarely a wait: each call that
        drops the interpreter lock costs the leader a turn among its
        spinning clients."""
        q = self._pending
        while len(q) > keep:
            q.popleft()[0].wait()

    def send(self, name: str, args=(), kw=None) -> None:
        """The leader: enqueue one record (never blocks on a follower)."""
        t0 = time.perf_counter()
        kw = kw or {}
        data = pickle.dumps((self._seq, name, args, kw),
                            protocol=pickle.HIGHEST_PROTOCOL)
        room = self.HEAD - 8
        head = np.zeros(self.HEAD, np.uint8)
        head[:8] = np.frombuffer(len(data).to_bytes(8, "little"), np.uint8)
        first = data[:room]
        head[8:8 + len(first)] = np.frombuffer(first, np.uint8)
        bufs = [torch.from_numpy(head)]
        if len(data) > room:
            bufs.append(torch.from_numpy(
                np.frombuffer(data[room:], np.uint8).copy()))
        self._reap()
        for b in bufs:
            work = self._dist.broadcast(b, self.leader_rank,
                                        group=self.group, async_op=True)
            self._pending.append((work, b))
        self._seq += 1
        if self.log is not None:
            self.log.append((name, args, kw))
            self.send_s.append(time.perf_counter() - t0)

    def recv(self):
        """A follower: the next record's ``(name, args, kw)``."""
        head = torch.empty(self.HEAD, dtype=torch.uint8)
        self._dist.broadcast(head, self.leader_rank, group=self.group)
        raw = head.numpy()
        n = int.from_bytes(raw[:8].tobytes(), "little")
        room = self.HEAD - 8
        data = raw[8:8 + min(n, room)].tobytes()
        if n > room:
            rest = torch.empty(n - room, dtype=torch.uint8)
            self._dist.broadcast(rest, self.leader_rank, group=self.group)
            data += rest.numpy().tobytes()
        seq, name, args, kw = pickle.loads(data)
        if seq != self._seq:
            raise ChannelError(
                f"mesh index {self.index} expected record {self._seq}, "
                f"got {seq} ({name})")
        self._seq += 1
        return name, args, kw

    # -- calls --------------------------------------------------------------
    @property
    def replaying(self) -> bool:
        """True inside a recorded call (or a follower's replay) on this
        thread: nested calls are part of it and send nothing."""
        return bool(getattr(self._tls, "depth", 0))

    @contextlib.contextmanager
    def record(self, name: str, args=(), kw=None):
        """One call of the structure: the leader sends its record first;
        a follower calling the structure itself receives the leader's and
        raises :class:`ChannelError` unless it is the same call.  Held
        under :attr:`lock`, so records go out in the order the calls
        run whatever thread makes them."""
        if self.replaying:
            yield
            return
        with self.lock:
            if self.is_leader:
                self.send(name, args, kw)
            else:
                got = self.recv()
                if got[0] != name or not _same(got[1:], (args, kw or {})):
                    raise ChannelError(
                        f"mesh index {self.index} called {name}{args!r} "
                        f"where the leader called {got[0]}{got[1]!r}")
            self._tls.depth = 1
            try:
                yield
            finally:
                self._tls.depth = 0

    def verdict(self, ok: bool = True) -> bool:
        """A guarded dispatch's outcome: the leader sends ``ok``, a
        follower returns the leader's."""
        if self.is_leader:
            self.send(VERDICT, (bool(ok),))
            return ok
        name, args, _ = self.recv()
        if name != VERDICT:
            raise ChannelError(f"mesh index {self.index} expected the "
                               f"leader's verdict, got {name}")
        return bool(args[0])

    def follow(self, target):
        """A follower: replay the leader's records on ``target`` until
        the leader closes it, and return the structure followed last (a
        :data:`REBUILD` record replaces it with ``target.rebuilt(**kw)``).
        A call the leader's structure refused (``ValueError``) or gave up
        on (an injected fault past its retries) is refused here too; any
        other error raises, on this rank, and the leader's next collective
        on the structure's group then raises on its own."""
        if self.is_leader:
            raise RuntimeError("the leader (mesh index 0) runs the calls; "
                               "only the other ranks follow them")
        self._tls.depth = 1
        try:
            while self.group is not None:   # the replayed close clears it
                name, args, kw = self.recv()
                if name == REBUILD:
                    target = target.rebuilt(**kw)
                    continue
                try:
                    _led_function(target, name)(target, *args, **kw)
                except (ValueError, InjectedFault):
                    pass
            return target
        finally:
            self._tls.depth = 0

    def close(self) -> None:
        """Wait for every send, meet the other ranks (the leader's last
        record has arrived everywhere), and destroy the group."""
        if self.group is None:
            return
        while self._pending:
            self._pending.popleft()[0].wait()
        self._dist.barrier(group=self.group)
        if self._dist.is_initialized():
            self._dist.destroy_process_group(self.group)
        self.group = None


def _led_function(target, name: str):
    cls_name, _, attr = name.rpartition(".")
    for cls in type(target).__mro__:
        if cls.__name__ == cls_name and attr in cls.__dict__:
            fn = cls.__dict__[attr]
            replay = getattr(fn, "led_replay", None)
            return getattr(type(target), replay) if replay else fn
    raise ChannelError(f"{type(target).__name__} has no {name}")


def led(fn=None, *, send_args: bool = True, replay: Optional[str] = None):
    """Wrap a placed structure's method so it runs through the structure's
    :class:`DispatchChannel` (``self._comm.channel``; a stacked structure
    has none and runs the method as it is).  ``send_args=False`` sends the
    name alone (the arguments are device tensors or handles: the follower
    calls the method bare); ``replay`` names the method a follower's
    :meth:`DispatchChannel.follow` runs in its place."""

    def wrap(fn):
        name = fn.__qualname__

        @functools.wraps(fn)
        def call(self, *args, **kw):
            ch = getattr(self.__dict__.get("_comm"), "channel", None)
            if ch is None:
                return fn(self, *args, **kw)
            with ch.record(name, args if send_args else (),
                           kw if send_args else None):
                return fn(self, *args, **kw)

        call.led_replay = replay
        return call

    return wrap(fn) if fn is not None else wrap


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
    def is_leader(self) -> bool:
        """True on the mesh's index 0, the rank whose threaded front end
        combines; the other ranks follow its dispatches."""
        return self.index == 0

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

    def new_group(self, backend: Optional[str] = None):
        """A process group over the mesh's ranks (NCCL on a CUDA mesh,
        gloo on a CPU one, unless ``backend`` says).  Every rank of the
        default group calls it, in the same order; a rank outside the mesh
        is refused after."""
        import torch.distributed as dist

        if backend is None:
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
