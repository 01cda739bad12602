"""Label propagation to the component-min fixpoint: the hand-written CUDA
kernel (``csrc/label_prop.cu``) and its plain PyTorch version (DESIGN.md
§11).

One iteration is the reference's ``label_step_xla``: ``s`` = the
scatter-min over edges of ``min(l[u], l[v])``, then ``l' = min(s, l[s])``
— the pointer jump reads the OLD labels.  Iterated from the identity, the
labels converge to the component-min id (labels only decrease, ``l[x] ≤
x`` is invariant, and the min vertex of every component is a fixpoint of
both the hook and the jump).  That fixpoint is unique, so any algorithm
that computes the component-min labelling reaches it bit for bit.

:func:`propagate` is the one entry point; it picks its path from the
output tensor's device: a CUDA tensor launches the kernel (ONE launch a
call) or raises; a CPU tensor runs :func:`propagate_plain`.
``propagate.launches`` counts kernel launches.  The kernel has three
bodies, and :func:`pick_body` chooses one from the form of the call and
the edge slot count the host already knows:

- ``"step"`` — ``init`` given or ``max_iters < MAX_ITERS``: the iteration
  above, stepped inside one cooperative launch until a step changes
  nothing or ``max_iters`` steps ran.
- ``"fixpoint"`` — the whole fixpoint from the identity (the graph's full
  rebuild; the relabel form of more than :data:`SMALL_E` slots): a
  concurrent union-find that links the larger root under the smaller, so
  every root is its tree's least vertex — the component-min labelling
  whatever order its atomics land in.
- ``"merge"`` — the relabel form of at most :data:`SMALL_E` slots (the
  graph's pending inserts, the union-find's ≤ c_max unions): the union-find
  of the ≤ 2·SMALL_E endpoint labels, built in shared memory, then one
  pass over the labels that rewrites only those whose root differs.

The return value: the step form returns the number of steps run; the
fixpoint forms (``"fixpoint"``, ``"merge"``) return 1 when they ran and 0
when gated off or when the relabel form has no live slot.  The plain
version returns the same.

The reference's three layers are thin calls to :func:`propagate`:
:func:`label_step` (``max_iters=1``), :func:`connected_components` (the
full fixpoint from the identity) and :func:`merge_labels` (the union-find
fast path: the fixpoint of the CONTRACTED graph whose vertices are the
current labels, composed with them).

The reference pads the vertex set to ``n_shards`` blocks and the edges to
the TPU kernel's streaming chunk; neither padding changes the result, and
here ``n_shards`` is kept for API parity only.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build

MAX_ITERS = 2 ** 31 - 1       # "to the fixpoint": int32 max
SMALL_E = 64                  # csrc/label_prop.cu's kSmallE: the most edge
                              # slots the merge body takes
BODIES = {"step": 0, "fixpoint": 1, "merge": 2}


def label_step_plain(labels: torch.Tensor, eu: torch.Tensor,
                     ev: torch.Tensor) -> torch.Tensor:
    """Torch twin of the reference's ``label_step_xla`` (element-wise
    identical): one scatter-min hook + pointer jump through the OLD
    labels.  ``eu``/``ev``: (E,) endpoints, invalid slots as (0, 0)."""
    l = labels.to(torch.int32)
    eu, ev = eu.long(), ev.long()
    m = torch.minimum(l[eu], l[ev])
    s = l.clone()
    s.scatter_reduce_(0, eu, m, reduce="amin")
    s.scatter_reduce_(0, ev, m, reduce="amin")
    return torch.minimum(s, l[s.long()])


def _live_edges(eu, ev, valid, e_live):
    """The edge list with dead slots sanitized to (0, 0) self-loops, and
    the live-prefix length the kernel would see."""
    E = eu.numel()
    live = torch.ones(E, dtype=torch.bool, device=eu.device)
    n_live = E
    if valid is not None:
        live &= valid
    if e_live is not None:
        n_live = min(E, max(int(e_live), 0))
        live &= torch.arange(E, device=eu.device) < n_live
    return torch.where(live, eu, 0), torch.where(live, ev, 0), n_live


def propagate_plain(eu: torch.Tensor, ev: torch.Tensor, out: torch.Tensor,
                    *, init: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None,
                    e_live: Optional[torch.Tensor] = None,
                    relabel: bool = False,
                    when: Optional[torch.Tensor] = None,
                    unless: Optional[torch.Tensor] = None,
                    max_iters: int = MAX_ITERS) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device (it reads the
    gates and the change test on the host).  Arguments and return value as
    :func:`propagate`: the step form returns the steps run, the fixpoint
    forms 1 when they ran (it steps them to the fixpoint all the same)."""
    dev = out.device
    none = torch.zeros((), dtype=torch.int32, device=dev)
    fixpoint = init is None and max_iters == MAX_ITERS
    if when is not None and not bool(when):
        return none
    if unless is not None and bool(unless):
        return none
    u, v, n_live = _live_edges(eu, ev, valid, e_live)
    n = out.numel()
    if relabel:
        if n_live == 0:
            return none                  # contracted graph of no edge
        cur = out.long()
        u, v = out[u.long()], out[v.long()]
        l = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        l = (init.to(torch.int32).clone() if init is not None
             else torch.arange(n, dtype=torch.int32, device=dev))
    it = 0
    while it < max_iters:
        l2 = label_step_plain(l, u, v)
        it += 1
        more = not torch.equal(l2, l)
        l = l2
        if not more:
            break
    out.copy_(l[cur] if relabel else l)
    return torch.full((), 1 if fixpoint else it, dtype=torch.int32,
                      device=dev)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def pick_body(E: int, *, init: Optional[torch.Tensor] = None,
              relabel: bool = False, max_iters: int = MAX_ITERS) -> str:
    """The kernel body a call of ``E`` edge slots runs: ``"step"`` when
    ``init`` is given or ``max_iters < MAX_ITERS``, else ``"merge"`` for the
    relabel form of at most :data:`SMALL_E` slots, else ``"fixpoint"``."""
    if init is not None or max_iters < MAX_ITERS:
        return "step"
    return "merge" if relabel and E <= SMALL_E else "fixpoint"


def propagate(eu: torch.Tensor, ev: torch.Tensor, out: torch.Tensor, *,
              init: Optional[torch.Tensor] = None,
              valid: Optional[torch.Tensor] = None,
              e_live: Optional[torch.Tensor] = None,
              relabel: bool = False,
              when: Optional[torch.Tensor] = None,
              unless: Optional[torch.Tensor] = None,
              max_iters: int = MAX_ITERS) -> torch.Tensor:
    """Run label propagation into ``out`` ((n,) int32, in place).

    eu/ev: (E,) int32 endpoints in [0, n).  A slot is the (0, 0) no-op
    when ``valid[e]`` is False ((E,) bool) or ``e >= e_live`` (() int32 on
    the device).  The labels start at ``init`` ((n,) int32) or the
    identity.  ``relabel``: the contracted form of ``merge_labels`` —
    ``out`` holds valid component labels, edges map through them, and
    ``out[x]`` becomes ``p[out[x]]`` for the contracted fixpoint ``p``.
    ``when`` / ``unless`` (() bool on the device): do nothing unless
    ``when`` is True and ``unless`` is False — the choice is made on the
    device, so the host reads neither.  Stops after the first step that
    changes nothing, or after ``max_iters`` steps.

    The body is :func:`pick_body`'s.  Returns a () int32 tensor on
    ``out``'s device, without synchronising: the step form's number of
    steps run (0 when gated off); for the fixpoint forms (no ``init``,
    ``max_iters == MAX_ITERS``) 1 when the launch ran and 0 when gated off
    or when the relabel form has no live slot."""
    if out.device.type == "cpu":
        return propagate_plain(eu, ev, out, init=init, valid=valid,
                               e_live=e_live, relabel=relabel, when=when,
                               unless=unless, max_iters=max_iters)
    body = pick_body(eu.numel(), init=init, relabel=relabel,
                     max_iters=max_iters)
    ret = propagate_body(body, eu, ev, out, init=init, valid=valid,
                         e_live=e_live, relabel=relabel, when=when,
                         unless=unless, max_iters=max_iters)
    propagate.launches += 1
    return ret


propagate.launches = 0


def propagate_body(body: str, eu: torch.Tensor, ev: torch.Tensor,
                   out: torch.Tensor, *,
                   init: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None,
                   e_live: Optional[torch.Tensor] = None,
                   relabel: bool = False,
                   when: Optional[torch.Tensor] = None,
                   unless: Optional[torch.Tensor] = None,
                   max_iters: int = MAX_ITERS) -> torch.Tensor:
    """One launch of one body (a key of :data:`BODIES`) on CUDA tensors;
    counts nothing.  :func:`propagate` picks the body; this is for timing
    one body against another on the card."""
    dev = out.device
    n, E = out.numel(), eu.numel()
    if n < 1:
        raise ValueError("label_prop needs at least one vertex")
    if not 0 <= max_iters <= MAX_ITERS:
        raise ValueError(f"max_iters must lie in [0, {MAX_ITERS}]")
    if relabel and init is not None:
        raise ValueError("the relabel form starts from the identity")
    if body not in BODIES:
        raise ValueError(f"unknown label_prop body {body!r}")
    if body != "step" and (init is not None or max_iters != MAX_ITERS):
        raise ValueError(f"the {body} body runs to the fixpoint from the "
                         "identity")
    if body == "merge" and not (relabel and E <= SMALL_E):
        raise ValueError(f"the merge body takes the relabel form of at "
                         f"most {SMALL_E} edge slots")
    _build.require(out, "out", torch.int32, (n,), dev)
    _build.require(eu, "eu", torch.int32, (E,), dev)
    _build.require(ev, "ev", torch.int32, (E,), dev)
    for t, name, dtype, shape in ((valid, "valid", torch.bool, (E,)),
                                  (e_live, "e_live", torch.int32, ()),
                                  (init, "init", torch.int32, (n,)),
                                  (when, "when", torch.bool, ()),
                                  (unless, "unless", torch.bool, ())):
        if t is not None:
            _build.require(t, name, dtype, shape, dev)
    lib = _build.library()
    code = BODIES[body]
    scratch = torch.empty(max(lib.label_prop_scratch_words(code, n), 1),
                          dtype=torch.int32, device=dev)
    ctrl = torch.empty(4, dtype=torch.int32, device=dev)
    rc = lib.label_prop_launch(
        code, n, eu.data_ptr(), ev.data_ptr(), E, _ptr(valid), _ptr(e_live),
        _ptr(init), int(bool(relabel)), _ptr(when), _ptr(unless),
        out.data_ptr(), scratch.data_ptr(), ctrl.data_ptr(), int(max_iters),
        _build.stream(dev))
    _build.check(rc, f"label_prop ({body})")
    return ctrl[0]


def label_step(labels: torch.Tensor, eu: torch.Tensor, ev: torch.Tensor, *,
               n_shards: int = 1) -> torch.Tensor:
    """One iteration (the reference's ``label_step``): a new (n,) int32
    label array.  ``n_shards`` does not change the result (API parity)."""
    out = torch.empty_like(labels, dtype=torch.int32)
    propagate(eu, ev, out, init=labels.to(torch.int32), max_iters=1)
    return out


def propagate_collective(eu: torch.Tensor, ev: torch.Tensor,
                         out: torch.Tensor, comm, *,
                         valid: Optional[torch.Tensor] = None,
                         when: Optional[torch.Tensor] = None,
                         prop=propagate) -> None:
    """The full fixpoint from the identity with the EDGE SLOTS split
    across a mesh (DESIGN.md §18; the reference's ``_cc_collective``).

    ``comm``: a placed structure's collectives (``core.placement``): rank
    ``d`` of ``comm.n`` runs the fixpoint over its block of the slots
    (padded with dead slots to a multiple of ``n``) into a table of its
    own, an all-gather gives the ``n`` tables, and one more fixpoint over
    the ``n · |out|`` star edges ``(v, L_d[v])`` writes ``out``.  The star
    graphs have the components of the blocks, whose union is the graph,
    and the component-min labelling is unique: ``out`` is the stacked
    rebuild's bit for bit.  ``valid`` and ``when`` as :func:`propagate`
    (gated off, the block tables stay the identity and ``out`` is not
    written).  ``prop`` is the yardstick seam (:func:`propagate_plain` on
    the card's plain pass); every rank of the mesh calls this, or none
    does (the caller's host-side decision is the same on every rank)."""
    n, E = out.numel(), eu.numel()
    dev = out.device
    blk = -(-max(E, 1) // comm.n)
    pad = blk * comm.n - E
    if valid is None:
        valid = torch.ones(E, dtype=torch.bool, device=dev)
    if pad:
        z = torch.zeros(pad, dtype=torch.int32, device=dev)
        eu, ev = torch.cat([eu, z]), torch.cat([ev, z])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool,
                                              device=dev)])
    sl = slice(comm.index * blk, (comm.index + 1) * blk)
    table = torch.arange(n, dtype=torch.int32, device=dev)
    prop(eu[sl], ev[sl], table, valid=valid[sl], when=when)
    tables = comm.gather(table[None])                      # (n_ranks, n)
    star_u = torch.arange(n, dtype=torch.int32, device=dev).repeat(comm.n)
    prop(star_u, tables.reshape(-1), out, when=when)


def connected_components(eu: torch.Tensor, ev: torch.Tensor, *, n: int,
                         n_shards: int = 1, use_pallas: bool = False,
                         placement=None) -> torch.Tensor:
    """Component-min labels of the graph on [0, n) with the given edges
    (invalid slots sanitized to (0, 0)).  ``n_shards``/``use_pallas`` are
    kept for API parity: the device picks the path.  ``placement``: a
    ``core.placement.MeshPlacement`` splits the edges across its ranks
    (:func:`propagate_collective`, over the mesh's own group; every rank
    of the mesh calls this); ``None`` or stacked runs one launch."""
    out = torch.empty(n, dtype=torch.int32, device=eu.device)
    if placement is not None and placement.is_mesh:
        propagate_collective(eu, ev, out, placement.comm(own_group=False))
    else:
        propagate(eu, ev, out)
    return out


def merge_labels(labels: torch.Tensor, eu: torch.Tensor, ev: torch.Tensor,
                 *, n: int) -> torch.Tensor:
    """Union-find fast path: fold a batch of NEW edges into a valid
    component-min labeling of the graph without them (the contracted
    fixpoint, composed).  Invalid edge slots must be (0, 0)."""
    out = labels.to(torch.int32).clone()
    if out.numel() != n:
        raise ValueError(f"labels must have {n} entries")
    propagate(eu, ev, out, relabel=True)
    return out


__all__ = ["BODIES", "MAX_ITERS", "SMALL_E", "connected_components",
           "label_step", "label_step_plain", "merge_labels", "pick_body",
           "propagate", "propagate_body", "propagate_collective",
           "propagate_plain"]
