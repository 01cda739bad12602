"""The batched-structure protocol + workload registry (DESIGN.md §16).

The paper's construction is *generic*: any parallel batched data
structure becomes a concurrent one under parallel combining.  Our
structures grew the shared idioms — fused donated apply passes, a
vectorized read pass, snapshot/restore for transactional dispatch
(DESIGN.md §15), a sync-free occupancy guard with a host mirror, rounds
lowering onto one scan program (DESIGN.md §12), and the async one-fetch
contract (update masks ride the next read's single blocking transfer) —
by copy-adaptation.  This module names the contract once:

* :class:`BatchedStructure` — the protocol base class.  A structure
  implements ``update_batch_async`` / ``read_batch`` / ``_snapshot`` /
  ``_restore`` (plus a ``read_only`` method set) and inherits the
  blocking ``update_batch``, the generic ``apply``, and the public
  snapshot surface the fault guards drive.

* :class:`StructureSpec` + the registry — the one place a workload
  describes itself: device/host factories, op generators, result
  tolerances, the canonical op images and log-compaction rule the
  adaptive tier needs (DESIGN.md §14), the refusal probe for the atomic
  occupancy guard, and serving/bench enrollment.  ``launch/serve.py``
  workload choices, ``benchmarks/run.py`` steps, and the conformance kit
  (``tests/conformance.py``) all iterate this registry, so landing a new
  workload is: fused passes + a numpy oracle + one ``register()`` call.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple


class BatchedStructure:
    """Protocol base for device-resident parallel batched structures.

    Required surface (the combining tiers and the conformance kit drive
    nothing else):

    * ``read_only`` — class-level set of read method names; everything
      else is an update (``batched_read_optimized`` splits passes on it).
    * ``update_batch_async(methods, inputs) -> handle`` — dispatch the
      whole update list as fused device passes, results left on device;
      ``handle.result()`` resolves them (at most one blocking fetch,
      shared with any read pass that ran in between).  A refused batch
      (occupancy guard, invalid input) raises ``ValueError`` *before*
      any slice reaches the device and leaves device buffers and host
      mirror bit-identical.
    * ``read_batch(methods, inputs) -> list`` — answer the whole read
      list with one device program and ONE blocking fetch, which also
      resolves outstanding update handles and re-tightens the occupancy
      mirror.
    * ``_snapshot()`` / ``_restore(snap)`` — bit-identical rewind of
      device state + host mirrors; never donated, so a
      :class:`~repro_torch.core.faults.DispatchGuard` can restore after the
      failed pass consumed the live buffers (DESIGN.md §15).
    """

    structure: str = ""                       # registry name
    read_only: Set[str] = frozenset()
    # True on structures whose mixed_rounds() fuses the whole round list
    # into ONE donated scan program (DESIGN.md §17); the base fallback
    # below dispatches one program per round instead.  Every structure
    # MUST declare its value explicitly (the conformance kit asserts the
    # registry's megapass flag matches this attribute AND the observed
    # dispatch behavior — a spec cannot lie silently).
    supports_megapass: bool = False
    # True on structures whose constructor accepts ``placement=`` (the
    # DESIGN.md §18 shard-layout knob: StackedPlacement / MeshPlacement)
    # and whose fused passes have a shard_map twin.  The conformance
    # kit's placement-parity stage runs exactly on these.
    supports_placement: bool = False

    # -- required ------------------------------------------------------------
    def update_batch_async(self, methods: Sequence[str],
                           inputs: Sequence[Any]):
        raise NotImplementedError

    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        raise NotImplementedError

    def _snapshot(self):
        raise NotImplementedError

    def _restore(self, snap) -> None:
        raise NotImplementedError

    # -- derived (shared by every implementation) ----------------------------
    def update_batch(self, methods: Sequence[str],
                     inputs: Sequence[Any]) -> List[Any]:
        """Blocking ``update_batch_async`` (one fetch, at return)."""
        return self.update_batch_async(methods, inputs).result()

    def apply(self, method: str, input: Any = None) -> Any:
        """Generic single-op entry (Lock/FC wrappers, fuzz loops)."""
        if method in self.read_only:
            return self.read_batch([method], [input])[0]
        return self.update_batch([method], [input])[0]

    def occupancy_mirror(self) -> Dict[str, Any]:
        """Host-mirror arrays the occupancy guard accounts against
        (empty for structures with no occupancy bound).  The atomic
        refusal contract quantifies over this dict: a refused batch
        leaves every entry bit-identical."""
        return {}

    # public snapshot surface (the fault guards + conformance kit)
    def snapshot(self):
        return self._snapshot()

    def restore(self, snap) -> None:
        self._restore(snap)

    @classmethod
    def is_read(cls, method: str) -> bool:
        return method in cls.read_only

    def mixed_rounds(self, rounds: Sequence[Tuple[str, Sequence[str],
                                                  Sequence[Any]]]):
        """Dispatch R heterogeneous combining rounds (DESIGN.md §17).

        ``rounds`` is a list of ``(kind, methods, inputs)`` triples with
        ``kind in {"update", "read"}``.  Returns one handle per round,
        in round order; ``handle.result()`` yields the per-op results of
        that round (same shapes ``update_batch`` / ``read_batch`` would
        return).  Round r+1 observes ALL of round r's effects — the
        rounds are a serial schedule, only the *dispatch* is fused.

        This base implementation is the alternating-dispatch fallback:
        one device program per round (an ``update_batch_async`` or an
        eager ``read_batch``), so every structure supports the API.
        Fused structures set ``supports_megapass = True`` and override
        with a tagged-scan lowering: ONE donated program for the whole
        round list and one shared blocking fetch for every handle.
        """
        handles = []
        for kind, methods, inputs in rounds:
            if kind == "update":
                handles.append(self.update_batch_async(list(methods),
                                                       list(inputs)))
            elif kind == "read":
                handles.append(_DoneReads(self.read_batch(list(methods),
                                                          list(inputs))))
            else:
                raise ValueError(f"unknown round kind {kind!r} "
                                 f"(want 'update' or 'read')")
        return handles


class _DoneReads:
    """Handle wrapper for an already-answered read round, so the base
    ``mixed_rounds`` fallback returns a uniform handle-per-round list."""

    def __init__(self, results: List[Any]):
        self._results = results

    def result(self) -> List[Any]:
        return self._results


def conforms(obj: Any) -> bool:
    """Structural check: does ``obj`` expose the protocol surface?"""
    return all(callable(getattr(obj, m, None))
               for m in ("update_batch_async", "read_batch",
                         "_snapshot", "_restore", "update_batch", "apply")
               ) and hasattr(obj, "read_only")


# ---------------------------------------------------------------------------
# Workload registry
# ---------------------------------------------------------------------------
@dataclass
class StructureSpec:
    """Everything downstream layers need to know about one workload.

    ``make(**kw)`` accepts the uniform knob set (``donate``,
    ``use_pallas``, ``fault_plan``, ``guard``, ``placement`` on
    structures with ``supports_placement``, plus per-structure sizing
    overrides) and returns a fresh :class:`BatchedStructure`;
    ``make_host(ds)`` returns a state-equal host oracle/mirror for the
    adaptive tier (DESIGN.md §14) and the differential batteries.

    The op generators draw (methods, inputs) batches with a persistent
    ``ctx`` (``new_ctx()``) so pools of previously-touched keys generate
    duplicate/delete-reinsert schedules; they drive BOTH the conformance
    kit and the synthetic serving workloads (``launch/serve.py``).
    """

    name: str
    module: str                               # owns the _host_fetch hook
    make: Callable[..., BatchedStructure]
    make_host: Callable[[BatchedStructure], Any]
    title: str = ""
    # op generation: (rng, k, ctx) -> (methods, inputs)
    gen_update: Optional[Callable] = None
    gen_read: Optional[Callable] = None
    new_ctx: Callable[[], Any] = dict
    # result comparison: (method, got, want) -> bool
    result_ok: Callable[[str, Any, Any], bool] = \
        staticmethod(lambda m, g, w: g == w)
    # whole-state comparison: (ds, oracle) -> None (asserts)
    dump_compare: Optional[Callable] = None
    # adaptive-tier hooks (DESIGN.md §14)
    canon: Callable[[str, Any], Any] = staticmethod(lambda m, i: i)
    compact: Optional[Callable] = None        # (log, host) -> ops
    # atomic-refusal probe: (ds) -> (methods, inputs) guaranteed refused
    refusal_batch: Optional[Callable] = None
    # True when read_batch's fetch resolves outstanding update handles
    # (map/graph/sketch/union-find); the PQ's documented contract is one
    # fetch per consumed apply instead
    reads_resolve_updates: bool = True
    # True when mixed_rounds() fuses the round list into one donated
    # scan program (DESIGN.md §17); the conformance kit then also
    # asserts the one-fetch + donation-aliasing contract on it
    megapass: bool = False
    # serving + bench enrollment
    serve: bool = True                        # expose as a serve.py workload
    bench: Optional[str] = None               # "benchmarks.bench_<name>"
    bench_smoke: Tuple[str, ...] = ()         # quick-sweep argv for run.py
    extras: Dict[str, Any] = field(default_factory=dict)


_REGISTRY: Dict[str, StructureSpec] = {}

# modules whose import registers the built-in workloads (each module
# calls register() at import time, so the registry can't drift from the
# structures themselves)
_BUILTIN_MODULES = (
    "repro_torch.core.sharded_pq",
)


def register(spec: StructureSpec) -> StructureSpec:
    """Idempotent by name: re-registration replaces (module reloads)."""
    _REGISTRY[spec.name] = spec
    return spec


def load_builtins() -> None:
    """Import every built-in structure module (each registers itself)."""
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def get(name: str) -> StructureSpec:
    if name not in _REGISTRY:
        load_builtins()
    if name not in _REGISTRY:
        raise KeyError(f"unknown structure {name!r} "
                       f"(have {sorted(_REGISTRY)})")
    return _REGISTRY[name]


def names() -> List[str]:
    load_builtins()
    return sorted(_REGISTRY)


def specs() -> List[StructureSpec]:
    return [_REGISTRY[n] for n in names()]


def try_get(name: str) -> Optional[StructureSpec]:
    """Like :func:`get` but None for unknown names — the adaptive tier
    uses it so ad-hoc structures keep working without a registration."""
    try:
        return get(name)
    except KeyError:
        return None
