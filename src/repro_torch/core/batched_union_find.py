"""Device-resident batched union-find (DESIGN.md §16).

The port of ``repro.core.batched_union_find``.  The graph's
``merge_labels`` fast path already computes exactly the union-find
transition — fold a batch of new edges into a valid component-min
labeling via the CONTRACTED-graph fixpoint — so a union pass is one
relabel-form launch of the ``label_prop`` kernel (its plain version on a
CPU structure), wrapped in the substrate idioms: an in-place apply pass
with a clone-per-pass twin, rounds back to back on one stream (DESIGN.md
§12), transactional snapshot/restore (DESIGN.md §15), the async one-fetch
contract (DESIGN.md §11), and an atomic validation guard (out-of-range
vertices refuse with ``ValueError`` before anything reaches the device).

State is the canonical min-label array over vertices ``[0, n)`` —
``find(u)`` is the smallest vertex id in ``u``'s component, so labels
compare bit-exact against
:class:`~repro_torch.core.seq_union_find.SequentialUnionFind`.

Batch semantics — the PRE-BATCH snapshot rule (DESIGN.md §9's "extracts
see the pre-batch multiset"): every ``union`` in one batch reports True
iff its endpoints were in different components at batch START, whatever
earlier in-batch unions did; all unions apply together.

Unlike the reference, batches wider than ``c_max`` are not padded to a
power of two of rows (there is no jit cache to bound).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Set

import numpy as np
import torch

from ..kernels.label_prop import propagate
from . import substrate
from .batched_pq import _device_get, resolve_device
from .faults import make_guard
from .seq_union_find import SequentialUnionFind

# test hook: module-level so sync-counting tests can monkeypatch it
_host_fetch = _device_get

RD_FIND = 0
RD_CONN = 1
RD_COMPS = 2
_READ_CODE = {"find": RD_FIND, "connected": RD_CONN,
              "components": RD_COMPS}


class UFState(NamedTuple):
    labels: torch.Tensor  # (n,) int32 component-min labeling (a fixpoint)


def _apply_impl(state: UFState, eu: torch.Tensor, ev: torch.Tensor,
                nb: int, *, prop: Callable = propagate):
    """Fold ≤ c_max unions as ONE pass, in place.

    ``eu``/``ev``: (c,) int32 endpoints; ``nb``: live lanes (host int).
    Returns ``(state, ok (c,) bool)`` — ok per the pre-batch rule, left on
    the device.  ``prop`` is the yardstick seam (``chip_smoke.py`` swaps
    in the plain version on the card)."""
    labels = state.labels
    c = eu.shape[0]
    active = torch.arange(c, device=eu.device) < nb
    u = torch.where(active, eu, 0)
    v = torch.where(active, ev, 0)
    ok = active & (labels[u.long()] != labels[v.long()])
    prop(u[:nb], v[:nb], labels, relabel=True)
    return state, ok


def _rounds_impl(state: UFState, eu: torch.Tensor, ev: torch.Tensor,
                 nb: Sequence[int], *, prop: Callable = propagate):
    """R sequential ≤ c_max slices back to back (DESIGN.md §12).
    ``eu``/``ev``: (R, c); ``nb``: R host ints.  The ok masks follow the
    pre-batch rule, so they gather against the labels BEFORE any slice."""
    labels0 = state.labels
    c = eu.shape[1]
    nb_t = torch.from_numpy(np.asarray(nb, np.int64)).to(eu.device,
                                                        non_blocking=True)
    active = torch.arange(c, device=eu.device)[None, :] < nb_t[:, None]
    u = torch.where(active, eu, 0)
    v = torch.where(active, ev, 0)
    oks = active & (labels0[u.long()] != labels0[v.long()])
    for r, k in enumerate(nb):
        _apply_impl(state, eu[r], ev[r], k, prop=prop)
    return state, oks


def apply_pass(state, eu, ev, nb, *, donate: bool = True,
               prop: Callable = propagate):
    """One union slice; ``donate=False`` runs it on a clone (the
    copy-per-pass ablation twin)."""
    if not donate:
        state = UFState(state.labels.clone())
    return _apply_impl(state, eu, ev, nb, prop=prop)


def apply_rounds(state, eu, ev, nb, *, donate: bool = True,
                 prop: Callable = propagate):
    if not donate:
        state = UFState(state.labels.clone())
    return _rounds_impl(state, eu, ev, nb, prop=prop)


def read_pass(state: UFState, qa: torch.Tensor, qb: torch.Tensor,
              qkind: torch.Tensor) -> torch.Tensor:
    """Answer a mixed read batch in one pass: ``find`` gathers the label,
    ``connected`` compares two, ``components`` counts label fixpoints
    (i == labels[i]).  Returns (q,) int32."""
    labels = state.labels
    n = labels.shape[0]
    qa, qb = qa.long(), qb.long()
    fnd = labels[qa]
    conn = (labels[qa] == labels[qb]).to(torch.int32)
    comps = (labels == torch.arange(n, dtype=torch.int32,
                                    device=labels.device)).sum()
    return torch.where(qkind == RD_FIND, fnd,
                       torch.where(qkind == RD_CONN, conn,
                                   comps.to(torch.int32)))


class AsyncUFUpdate:
    """Deferred per-op merged flags (one-fetch contract, DESIGN.md §11)."""

    def __init__(self, owner: "BatchedUnionFind", masks: List[torch.Tensor],
                 lane_counts: List[int], c_max: int):
        self._owner: Optional["BatchedUnionFind"] = owner
        self.masks = masks
        self._lane_counts = lane_counts
        self._c_max = c_max
        self._out: Optional[List[bool]] = None

    def _resolve(self, masks_h) -> None:
        if masks_h and self._lane_counts:
            rows = np.concatenate(
                [np.asarray(m).reshape(-1, self._c_max) for m in masks_h],
                axis=0)
            out = np.concatenate(
                [rows[r, :nc] for r, nc in enumerate(self._lane_counts)])
        else:
            out = np.zeros((0,), bool)
        self._out = [bool(x) for x in out]
        self._owner = None
        self.masks = []

    def result(self) -> List[bool]:
        if self._out is None:
            self._owner._resolve_through(self)
        return self._out


class BatchedUnionFind(substrate.BatchedStructure):
    """Device-resident union-find over vertices ``[0, n)``.

    Args:
      n: vertex count (labels are (n,) int32).
      c_max: combined union-batch capacity per pass.
      n_shards, use_pallas: kept for API parity (the device picks the
        kernel path; the vertex partition never changes the result).
      donate / fault_plan / guard: the uniform knob set.
      device: ``None`` means the card (``"cuda"``) and raises without
        one; the tests pass ``"cpu"``.

    There is no occupancy bound (components only merge), so the atomic
    refusal contract is carried by validation: any out-of-range vertex
    refuses the WHOLE batch with ``ValueError`` before dispatch.
    """

    structure = "unionfind"
    read_only: Set[str] = {"find", "connected", "components"}
    # No fused megapass: mixed_rounds rides the base fallback (one
    # dispatch per round).
    supports_megapass = False
    batch_snapshot = True

    def __init__(self, n: int, c_max: int = 8, n_shards: int = 1,
                 use_pallas: bool = False, donate: bool = True,
                 fault_plan=None, guard=None, device=None):
        if n < 1:
            raise ValueError("n must be >= 1")
        if c_max < 1:
            raise ValueError("c_max must be >= 1")
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n = int(n)
        self.c_max = int(c_max)
        self.n_shards = int(n_shards)
        self.use_pallas = bool(use_pallas)
        self.donate = bool(donate)
        self.device = resolve_device(device)
        self.fault_plan = fault_plan
        self._guard = make_guard(fault_plan, guard)
        self.state = UFState(torch.arange(self.n, dtype=torch.int32,
                                          device=self.device))
        self._unresolved: List[AsyncUFUpdate] = []
        # the yardstick seam: only chip_smoke.py swaps in the plain
        # version, to hold the kernel pass against it on the card
        self._prop: Callable = propagate

    # -- transactional dispatch (DESIGN.md §15) -------------------------------
    def _snapshot(self):
        return UFState(self.state.labels.clone())

    def _restore(self, snap) -> None:
        self.state = snap

    def _check(self, u) -> int:
        u = int(u)
        if not 0 <= u < self.n:
            raise ValueError(f"vertex {u} outside [0, {self.n})")
        return u

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    # -- updates --------------------------------------------------------------
    def update_batch_async(self, methods: Sequence[str],
                           inputs: Sequence[Any]) -> AsyncUFUpdate:
        """Fold a combined union batch: ≤ c_max ops run as ONE pass; wider
        batches as ⌈ops / c_max⌉ passes back to back.  NO blocking
        transfer; results follow the pre-batch snapshot rule."""
        n_ops = len(methods)
        eu = np.zeros((n_ops,), np.int32)
        ev = np.zeros((n_ops,), np.int32)
        # validate the WHOLE batch before anything dispatches
        for i, (m, inp) in enumerate(zip(methods, inputs)):
            if m != "union":
                raise ValueError(f"unknown update method {m!r}")
            eu[i] = self._check(inp[0])
            ev[i] = self._check(inp[1])
        if n_ops == 0:
            handle = AsyncUFUpdate(self, [], [], self.c_max)
            handle._out = []
            return handle
        c = self.c_max
        n_rounds = -(-n_ops // c)
        us = np.zeros((n_rounds, c), np.int32)
        vs = np.zeros((n_rounds, c), np.int32)
        lane_counts: List[int] = []
        for r in range(n_rounds):
            nc = min(c, n_ops - r * c)
            us[r, :nc] = eu[r * c:r * c + nc]
            vs[r, :nc] = ev[r * c:r * c + nc]
            lane_counts.append(nc)

        def commit():
            us_t, vs_t = self._to_device(us), self._to_device(vs)
            if n_rounds == 1:
                self.state, ok = apply_pass(self.state, us_t[0], vs_t[0],
                                            lane_counts[0],
                                            donate=self.donate,
                                            prop=self._prop)
                return [ok]
            self.state, oks = apply_rounds(self.state, us_t, vs_t,
                                           lane_counts, donate=self.donate,
                                           prop=self._prop)
            return [oks]

        if self._guard is None:
            masks = commit()
        else:
            masks = self._guard.run(commit, self._snapshot, self._restore,
                                    site="unionfind.apply_pass")
        handle = AsyncUFUpdate(self, masks, lane_counts, c)
        self._unresolved.append(handle)
        return handle

    def _resolve_through(self, handle: Optional[AsyncUFUpdate],
                         extra=None):
        """ONE combined fetch resolves every unresolved handle plus
        ``extra`` (DESIGN.md §11)."""
        todo = list(self._unresolved)
        if handle is not None and handle not in todo:
            todo = []
        if not todo and extra is None:
            return None
        fetched = _host_fetch(([h.masks for h in todo], extra))
        for h, masks_h in zip(todo, fetched[0]):
            h._resolve(masks_h)
            self._unresolved.remove(h)
        return fetched[1]

    def union(self, u: int, v: int) -> bool:
        return self.update_batch(["union"], [(u, v)])[0]

    # -- reads ----------------------------------------------------------------
    def read_batch(self, methods: Sequence[str],
                   inputs: Sequence[Any]) -> List[Any]:
        """ONE device pass + ONE blocking fetch for the whole batch
        (which also resolves outstanding update handles)."""
        nq = len(methods)
        if nq == 0:
            return []
        q = np.zeros((3, nq), np.int32)          # qa, qb, kind
        for i, (m, inp) in enumerate(zip(methods, inputs)):
            if m not in _READ_CODE:
                raise ValueError(f"unknown read method {m!r}")
            q[2, i] = _READ_CODE[m]
            if m == "find":
                q[0, i] = self._check(inp)
            elif m == "connected":
                q[0, i] = self._check(inp[0])
                q[1, i] = self._check(inp[1])
        qt = self._to_device(q)
        res = read_pass(self.state, qt[0], qt[1], qt[2])
        res_h = np.asarray(self._resolve_through(None, extra=res))
        return [bool(res_h[i]) if m == "connected" else int(res_h[i])
                for i, m in enumerate(methods)]

    def find(self, u: int) -> int:
        return self.read_batch(["find"], [u])[0]

    def connected(self, u: int, v: int) -> bool:
        return self.read_batch(["connected"], [(u, v)])[0]

    def components(self) -> int:
        return self.read_batch(["components"], [None])[0]

    # -- debug / test helpers -------------------------------------------------
    def labels(self) -> List[int]:
        """Host copy of the canonical labeling (one fetch)."""
        return np.asarray(_host_fetch(self.state.labels)).tolist()

    def __len__(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# Registration (DESIGN.md §16)
# ---------------------------------------------------------------------------
N_DEFAULT = 48


def _gen_update(rng, k, ctx):
    """Union batches biased toward chain edges (long merge paths — the
    stress case for the contracted fixpoint) with random long links."""
    n = ctx.setdefault("n", N_DEFAULT)
    methods, inputs = [], []
    for _ in range(k):
        u = int(rng.integers(n))
        if rng.random() < 0.5:
            v = (u + 1) % n
        else:
            v = int(rng.integers(n))
        methods.append("union")
        inputs.append((u, v))
    return methods, inputs


def _gen_read(rng, k, ctx):
    n = ctx.setdefault("n", N_DEFAULT)
    methods, inputs = [], []
    for _ in range(k):
        r = rng.random()
        if r < 0.4:
            methods.append("find")
            inputs.append(int(rng.integers(n)))
        elif r < 0.8:
            methods.append("connected")
            inputs.append((int(rng.integers(n)), int(rng.integers(n))))
        else:
            methods.append("components")
            inputs.append(None)
    return methods, inputs


def _canon_op(method: str, input: Any) -> Any:
    """Normalize union/connected edges to sorted int tuples (DESIGN.md
    §14) so the compaction dedup sees (u, v) == (v, u)."""
    if method in ("union", "connected"):
        u, v = int(input[0]), int(input[1])
        return (min(u, v), max(u, v))
    if method == "find":
        return int(input)
    return input


def _compact(log, host):
    """Unions are idempotent on state: keep one per normalized edge."""
    seen, ops = set(), []
    for m, e in log:
        if e not in seen:
            seen.add(e)
            ops.append((m, e))
    return ops


def _host_mirror(ds: BatchedUnionFind) -> SequentialUnionFind:
    h = SequentialUnionFind(ds.n)
    h.load_labels(ds.labels())
    return h


def _dump_compare(ds: BatchedUnionFind,
                  oracle: SequentialUnionFind) -> None:
    assert ds.labels() == oracle.labels(), (ds.labels(), oracle.labels())


def _make(n: int = N_DEFAULT, c_max: int = 8, **kw) -> BatchedUnionFind:
    return BatchedUnionFind(n, c_max=c_max, **kw)


substrate.register(substrate.StructureSpec(
    name="unionfind",
    module="repro_torch.core.batched_union_find",
    title="batched union-find",
    make=_make,
    make_host=_host_mirror,
    gen_update=_gen_update,
    gen_read=_gen_read,
    dump_compare=_dump_compare,
    canon=_canon_op,
    compact=_compact,
    refusal_batch=lambda ds: (["union"], [(0, ds.n)]),
    extras={"serve_kw": dict(n=512, c_max=32)},
))
