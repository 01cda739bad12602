"""Mixture-of-Experts FFN with the reference's sort-based dispatch.

The port of the reference's ``models/moe.py``.  Tokens are ordered by
expert id with a stable sort and moved with gathers and scatters (bytes,
not FLOPs) into (E, C, D) expert buffers; the experts are three batched
products; GShard capacity drops are kept: C = max(1, min(ceil(T·K/E ·
capacity_factor), T)) slots an expert, and the assignments past them add
nothing (the shared expert and the residual carry those tokens).

The steps, each the reference's:

- :func:`route`: the router's logits in f32 from ``x.float()``, softmax,
  the top K by a stable descending sort (ties go to the lower expert id,
  as ``jax.lax.top_k`` breaks them; ``torch.topk`` does not promise that
  on CUDA), renormalised when ``router_norm_topk``;
- :func:`dispatch`: the flat (token, k) assignments stably sorted by
  expert, each one's position in its expert as a cumsum minus
  ``searchsorted(side="left")``, ``keep = pos < C``; a dropped assignment
  points at slot (0, C - 1) and adds zeros there, so the scatter
  (``index_put_(accumulate=True)``) writes each live slot once, exactly;
- the gated expert MLP: with ``moe_bf16_dispatch`` (llama4) the products
  return bf16 (f32 sums inside the GEMM) and the combine runs in bf16;
  otherwise they take their bf16 operands upcast to f32 (exact) and
  return f32 (the reference's ``preferred_element_type=float32``);
- the combine, in a fixed order: each token's K picks, router-weighted
  and masked, are summed one after another in (t, k) order, the most
  probable first (the reference's scatter-add leaves its order open) —
  no atomics, so a replay gives the same bits.

``moe_group_by_batch`` (deepseek) dispatches each batch row alone with a
per-row capacity (T = S), the reference's ``vmap``: here one batched sort
over (B, S·K) rows.  The shared expert is added in f32 and the sum cast
back to x's dtype.  The reference's expert-parallel and FSDP layouts
(``moe_fsdp_axis``, ``moe_ep_serve``) are :func:`moe_specs` and
``launch/sharding.py``'s.

**On a mesh** (x a DTensor) the dispatch computes what the reference's
GSPMD computes, the unsharded function.  Without ``moe_group_by_batch``
the group is the *global* batch's B·S tokens in (b, s) order and C =
:func:`capacity` of B·S; assignments are ordered by (expert, global
token, k), so an assignment's ``pos`` counts the earlier assignments to
its expert on every rank: each rank counts its own a expert, the counts
are all-gathered over the mesh dims that shard the batch (one (E,)
int32 a rank), and the shards earlier in DTensor's order (major first)
add to the local positions.  With it, a row never straddles a rank and
the dispatch is the local one.  The kept set, the router weights and the
(t, k) combine order are the unsharded port's.  The expert products run
where the weights lie (:func:`_mesh_plan`): a mesh dim that shards E
over replicated tokens (training: E over ``model``) has each rank run
its own experts and sum the picks' rows over the dim, one rank's row
and zeros; a dim that shards both E and the tokens (``moe_ep_serve``: E
over ``data``) moves the kept rows to their experts' ranks and back in
two fixed-shape ``all_to_all``s, min(C, local T) rows an expert a
sender, the receiver placing each at its global position in a (E/n, C,
D) buffer; a dim that shards F over replicated tokens (serving's F over
``model``) keeps F sharded and sums the down-projection's partial
products; every other sharded weight dim (FSDP) is gathered before use.
Every shape is static: no host sync, no data-dependent size.  At one
rank every collective is an identity and the result is the unsharded
one bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..optim.tree import shard_index
from .config import ArchConfig
from .layers import FSDP, TENSOR, act_fn, dense, dense_init, dense_specs, spec


def moe_init(gen: torch.Generator, cfg: ArchConfig, *,
             lead: Tuple[int, ...] = ()):
    m = cfg.moe
    D, F, E = cfg.d_model, m.d_ff, m.n_experts
    dev = gen.device

    def experts(d_in, d_out):
        w = torch.randn(lead + (E, d_in, d_out), generator=gen,
                        dtype=torch.float32, device=dev)
        return (w * d_in ** -0.5).to(torch.bfloat16)

    p = {"router": dense_init(gen, D, E, dtype=torch.float32, lead=lead),
         "w_up": experts(D, F), "w_gate": experts(D, F),
         "w_down": experts(F, D)}
    if m.n_shared:
        fs = (m.d_ff_shared or m.d_ff) * m.n_shared
        p["sh_up"] = dense_init(gen, D, fs, lead=lead)
        p["sh_gate"] = dense_init(gen, D, fs, lead=lead)
        p["sh_down"] = dense_init(gen, fs, D, lead=lead)
    return p


def moe_specs(cfg: ArchConfig):
    """The reference's specs for :func:`moe_init`'s leaves
    (``moe_fsdp_axis``: the expert weights' FSDP dim)."""
    s = {"router": dense_specs(out_axis=None)}
    if cfg.moe_fsdp_axis == "f":
        # Megatron-style: split the expert FFN dim
        s.update(w_up=spec(TENSOR, None, FSDP), w_gate=spec(TENSOR, None, FSDP),
                 w_down=spec(TENSOR, FSDP, None))
    else:
        s.update(w_up=spec(TENSOR, FSDP, None), w_gate=spec(TENSOR, FSDP, None),
                 w_down=spec(TENSOR, None, FSDP))
    if cfg.moe.n_shared:
        s.update(sh_up=dense_specs(), sh_gate=dense_specs(),
                 sh_down=dense_specs(in_axis=TENSOR, out_axis=FSDP))
    return s


def router_probs(p, xt: torch.Tensor) -> torch.Tensor:
    """(..., T, D) tokens -> (..., T, E) router probabilities in f32."""
    return torch.softmax(dense(p["router"], xt.float()), dim=-1)


def route(p, cfg: ArchConfig,
          xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top_p, top_e), each (..., T, K): the K most probable experts of
    each token, most probable first, ties to the lower expert id."""
    m = cfg.moe
    top_p, top_e = torch.sort(router_probs(p, xt), dim=-1, descending=True,
                              stable=True)
    top_p, top_e = top_p[..., :m.top_k], top_e[..., :m.top_k]
    if m.router_norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    return top_p, top_e


def capacity(cfg: ArchConfig, T: int) -> int:
    """Slots an expert for a group of T tokens (the reference's C)."""
    m = cfg.moe
    C = int(math.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
    return max(1, min(C, T))


def dispatch(top_e: torch.Tensor, n_experts: int, C: int,
             start: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The sort-based dispatch of (G, T, K) expert ids, each group alone:
    ``order`` (the stable sort of the flat assignments by expert), the
    sorted ``se`` (expert) and ``st`` (token), ``pos`` (place in its
    expert), ``keep``, and the buffer slot ``(slot_e, slot_c)`` of each
    sorted assignment, all (G, T·K).  ``start`` (G, E), on a mesh: each
    expert's assignments in the group's earlier tokens, on other ranks;
    ``pos`` counts them, the slot (of min(C, T) an expert) does not."""
    G, T, K = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    st = torch.div(order, K, rounding_mode="floor")   # flat index t·K + k
    pos_in_all = torch.arange(T * K, device=dev).expand(G, -1)
    seg_start = torch.searchsorted(
        se, torch.arange(n_experts, device=dev).expand(G, -1).contiguous(),
        side="left")
    here = pos_in_all - torch.gather(seg_start, -1, se)
    pos = here if start is None else here + torch.gather(start, -1, se)
    keep = pos < C
    return {"order": order, "se": se, "st": st, "pos": pos, "keep": keep,
            "slot_e": torch.where(keep, se, 0),
            "slot_c": torch.where(keep, here, min(C, T) - 1)}


def _expert_mm(a: torch.Tensor, w: torch.Tensor,
               acc: torch.dtype) -> torch.Tensor:
    """(E, N, X) @ (E, X, Y) -> (E, N, Y) in ``acc``, the reference's
    ``einsum(..., preferred_element_type=acc)``: operands of ``acc``'s
    dtype go as they are (a bf16 GEMM sums in f32 and rounds once); other
    pairs are upcast to f32, exactly, and the result cast to ``acc``."""
    if a.dtype == w.dtype == acc:
        return torch.bmm(a, w)
    return torch.bmm(a.float(), w.float()).to(acc)


# ---------------------------------------------------------------------------
# The dispatch on a mesh: each rank's local tensors, and the collectives
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Where one MoE call's work lies on ``mesh`` (mesh dims by index):
    ``tokens`` shard the batch (major first), ``experts`` shards E (or
    ``None``), ``tp`` shard F over replicated tokens.  ``mode``: ``"a2a"``
    when ``experts`` also shards the tokens, ``"split"`` when it does
    not, ``"local"`` without it."""

    mesh: Any
    tokens: Tuple[int, ...]
    experts: Optional[int]
    tp: Tuple[int, ...]

    @property
    def mode(self) -> str:
        if self.experts is None:
            return "local"
        return "a2a" if self.experts in self.tokens else "split"

    def expert_range(self, E: int) -> Tuple[int, int]:
        """(first, count) of this rank's experts."""
        n = self.mesh.size(self.experts)
        return self.mesh.get_local_rank(self.experts) * (E // n), E // n

    def token_shard(self) -> Tuple[int, int]:
        """(this rank's index, count) of the batch's shards, major first
        (DTensor's order)."""
        return shard_index(self.mesh, [md in self.tokens
                                       for md in range(self.mesh.ndim)])


def _c10d():
    """The functional collectives' ops (the ones DTensor issues, which the
    dry run's ``Recorder`` counts), each on a mesh dim's group."""
    return torch.ops._c10d_functional


def _all_reduce(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    ops = _c10d()
    for md in dims:
        t = ops.wait_tensor(ops.all_reduce(
            t.contiguous(), "sum", mesh.get_group(md).group_name))
    return t


def _all_gather(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``t`` of every rank over ``dims``, stacked on dim 0, major first."""
    ops = _c10d()
    for md in reversed(dims):
        t = ops.wait_tensor(ops.all_gather_into_tensor(
            t.contiguous(), mesh.size(md), mesh.get_group(md).group_name))
    return t


def _all_to_all(t: torch.Tensor, mesh, md: int) -> torch.Tensor:
    """Block i of dim 0 to rank i of ``md``; block i of the result from
    rank i (equal splits)."""
    ops = _c10d()
    n = mesh.size(md)
    split = [t.shape[0] // n] * n
    return ops.wait_tensor(ops.all_to_all_single(
        t.contiguous(), split, split, mesh.get_group(md).group_name))


class _Enter(torch.autograd.Function):
    """Identity; the gradient summed over ``dims`` (a replicated tensor
    entering work that each rank of ``dims`` does a part of)."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.dims), None, None


class _Leave(torch.autograd.Function):
    """The parts summed over ``dims``; the gradient, replicated over them,
    passed as it is."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        return _all_reduce(t, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Swap(torch.autograd.Function):
    """:func:`_all_to_all` over ``md``; its gradient goes back the same
    way (an equal-split exchange is its own inverse)."""

    @staticmethod
    def forward(ctx, t, mesh, md):
        ctx.mesh, ctx.md = mesh, md
        return _all_to_all(t, mesh, md)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.md), None, None


def _enter(t, plan: Optional[MeshPlan], dims):
    return t if plan is None or not dims else _Enter.apply(t, plan.mesh,
                                                             tuple(dims))


def _leave(t, plan: Optional[MeshPlan], dims):
    return t if plan is None or not dims else _Leave.apply(t, plan.mesh,
                                                             tuple(dims))


def _products(w, buf: torch.Tensor, acc: torch.dtype, act,
              plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """The gated expert MLP of (E', N, D) rows on the experts ``w`` holds
    (F whole, or sharded over ``plan.tp``: the partial down-projections
    summed there)."""
    tp = plan.tp if plan is not None else ()
    buf = _enter(buf, plan, tp)
    h = act(_expert_mm(buf, w["w_gate"], acc).float()) \
        * _expert_mm(buf, w["w_up"], acc).float()
    return _leave(_expert_mm(h.to(buf.dtype), w["w_down"], acc), plan, tp)


def _exchange(w, buf, C, acc, act, plan: MeshPlan, seen) -> torch.Tensor:
    """The ``a2a`` mode's expert stage: ``buf`` (E, G, Cl, D), this rank's
    rows of every expert, to the experts' ranks and their outputs back,
    (E, G, Cl, D).  A global group is placed by global position into
    (E/n, C, D) on the receiver (``seen``: every batch shard's (counts,
    starts), (N, E)); per-row groups (``seen`` None) are whole on their
    sender and run as they come."""
    E, G, Cl, D = buf.shape
    md = plan.experts
    lo, El = plan.expert_range(E)
    n = E // El
    recv = _Swap.apply(buf.reshape(n, El, G, Cl, D), plan.mesh, md)
    if seen is None:
        out = _products(w, recv.transpose(0, 1).reshape(El, n * G * Cl, D),
                        acc, act, plan)
        back = out.reshape(El, n, G, Cl, D).transpose(0, 1)
    else:
        counts, starts = seen
        idx, _ = plan.token_shard()
        stride = math.prod(plan.mesh.size(t) for t in plan.tokens
                           if t > md)
        me = plan.mesh.get_local_rank(md)
        dev = buf.device
        senders = idx + (torch.arange(n, device=dev) - me) * stride
        j = torch.arange(Cl, device=dev)
        at = starts[senders, lo:lo + El, None] + j                # (n, El, Cl)
        live = (j < counts[senders, lo:lo + El, None]) & (at < C)
        at = torch.where(live, at, C - 1)
        e = torch.arange(El, device=dev)[None, :, None].expand_as(at)
        rows = torch.where(live[..., None], recv[:, :, 0], 0)
        comp = buf.new_zeros((El, C, D))
        comp = comp.index_put((e, at), rows, accumulate=True)
        out = _products(w, comp, acc, act, plan)
        back = torch.where(live[..., None], out[e, at], 0)[:, :, None]
    return _Swap.apply(back, plan.mesh, md).reshape(E, G, Cl, D)


def _routed(p, cfg: ArchConfig, xt: torch.Tensor, act,
            plan: Optional[MeshPlan] = None,
            group: Optional[int] = None) -> torch.Tensor:
    """Sort-based dispatch over G token groups xt (G, T, D), each with its
    own capacity.  Returns (G, T, D) in the combine's dtype.  On a mesh
    (``plan``) xt is this rank's tokens and the result its rows; ``group``
    the global batch's tokens when xt (G = 1) is this rank's part of them,
    ``None`` when each group is whole here."""
    G, T, D = xt.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    dev = xt.device
    top_p, top_e = route(p, cfg, xt)
    C = capacity(cfg, group or T)
    Cl = min(C, T)
    start = seen = None
    if plan is not None and group is not None:
        # the assignments each expert has on the batch shards before this
        # one: one (E,) count a shard, gathered
        mine = torch.zeros((G, E), dtype=torch.int32, device=dev)
        mine.scatter_add_(-1, top_e.reshape(G, T * K), torch.ones_like(
            top_e.reshape(G, T * K), dtype=torch.int32))
        counts = _all_gather(mine, plan.mesh, plan.tokens).long()
        starts = torch.cumsum(counts, 0) - counts                  # (N, E)
        start = starts[plan.token_shard()[0]][None]
        seen = (counts, starts)
    d = dispatch(top_e, E, C, start)
    keep, slot_e, slot_c = d["keep"], d["slot_e"], d["slot_c"]
    gi = torch.arange(G, device=dev)[:, None].expand(G, T * K)
    acc = torch.bfloat16 if cfg.moe_bf16_dispatch else torch.float32
    mode = plan.mode if plan is not None else "local"

    # scatter tokens into (E', G, Cl, D) expert buffers: the live slots
    # get their token, the dropped assignments zeros at (0, Cl - 1)
    if mode == "split":                # this rank's experts alone
        lo, El = plan.expert_range(E)
        put = keep & (d["se"] >= lo) & (d["se"] < lo + El)
        src = _enter(xt, plan, (plan.experts,))
        tok = torch.where(put[..., None], src[gi, d["st"]], 0)
        buf = xt.new_zeros((El, G, Cl, D))
        buf.index_put_((torch.where(put, d["se"] - lo, 0), gi, slot_c), tok,
                       accumulate=True)
    else:
        tok = torch.where(keep[..., None], xt[gi, d["st"]], 0)
        buf = xt.new_zeros((E, G, Cl, D))
        buf.index_put_((slot_e, gi, slot_c), tok, accumulate=True)
    if mode == "a2a":
        out_buf = _exchange(p, buf, C, acc, act, plan, seen)
    else:
        out_buf = _products(p, buf.reshape(-1, G * Cl, D), acc, act, plan)
        out_buf = out_buf.reshape(-1, G, Cl, D)

    # each (t, k) pick in (t, k) order: its place among the sorted
    # assignments is inv[t·K + k]
    inv = torch.empty_like(d["order"])
    inv.scatter_(-1, d["order"], torch.arange(T * K, device=dev)
                 .expand(G, -1).contiguous())
    comb = xt.dtype if cfg.moe_bf16_dispatch else torch.float32
    e_, c_ = torch.gather(slot_e, -1, inv), torch.gather(slot_c, -1, inv)
    if mode == "split":                # the owner's row, zeros elsewhere
        ours = (e_ >= lo) & (e_ < lo + El)
        rows = torch.where(ours[..., None],
                           out_buf[(e_ - lo).clamp(0, El - 1), gi, c_], 0)
        rows = _leave(rows, plan, (plan.experts,))
    else:
        rows = out_buf[e_, gi, c_]
    w_ = top_p.reshape(G, T * K).to(comb)
    picked = rows.to(comb) * w_[..., None]
    picked = torch.where(torch.gather(keep, -1, inv)[..., None], picked, 0)
    picked = picked.reshape(G, T, K, D)
    y = picked[:, :, 0]
    for k in range(1, K):
        y = y + picked[:, :, k]
    return y


_EXPERTS = ("w_gate", "w_up", "w_down")
_F_DIM = {"w_gate": 2, "w_up": 2, "w_down": 1}


def _mesh_plan(p, x) -> MeshPlan:
    """The :class:`MeshPlan` of a call on the DTensor ``x`` (B, S, D) with
    the expert weights ``p``.  x must shard its batch evenly, and nothing
    else; the three expert weights must shard E over one mesh dim at
    most, the same for all three.  Any other layout raises
    ``ValueError``, naming it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    tokens, n = [], 1
    for md, pl in enumerate(x.placements):
        if pl == Shard(0):
            tokens.append(md)
            n *= mesh.size(md)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"the MoE dispatch takes tokens sharded on "
                             f"their batch dim only, not {x.placements}")
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not divide over "
                         f"{n} ranks")
    ws = [p[k] for k in _EXPERTS]
    if not all(isinstance(w, DTensor) and w.device_mesh == mesh
               for w in ws):
        raise ValueError("the expert weights are not DTensors on the "
                         "tokens' mesh")
    experts, tp = [], []
    for md in range(mesh.ndim):
        pls = [w.placements[md] for w in ws]
        if all(pl == Shard(0) for pl in pls):
            experts.append(md)
        elif any(pl == Shard(0) for pl in pls):
            raise ValueError(f"the expert weights shard E unlike each "
                             f"other on mesh dim {md}: {pls}")
        elif md not in tokens and all(
                pl == Shard(_F_DIM[k]) for k, pl in zip(_EXPERTS, pls)):
            tp.append(md)
    if len(experts) > 1:
        raise ValueError(f"the expert weights shard E over mesh dims "
                         f"{experts}; the dispatch takes one")
    if experts and ws[0].shape[0] % mesh.size(experts[0]):
        raise ValueError(f"{ws[0].shape[0]} experts do not divide over "
                         f"{mesh.size(experts[0])} ranks")
    return MeshPlan(mesh, tuple(tokens), experts[0] if experts else None,
                    tuple(tp))


def _local_weights(p, plan: MeshPlan):
    """The router's and the experts' local tensors: the router whole; the
    experts with E sharded over ``plan.experts`` and F over ``plan.tp``,
    every other dim gathered (FSDP before use).  Each gradient is
    declared as the rank computes it: a partial sum over the dims that
    shard the tokens, and whole over the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def one(w, keep):
        want = [keep.get(md, Replicate()) for md in range(plan.mesh.ndim)]
        grad = [keep.get(md, Partial() if md in plan.tokens else Replicate())
                for md in range(plan.mesh.ndim)]
        if list(w.placements) != want:
            w = w.redistribute(plan.mesh, want)
        return w.to_local(grad_placements=grad)

    out = {"router": {"w": one(p["router"]["w"], {})}}
    for k in _EXPERTS:
        keep = {md: Shard(_F_DIM[k]) for md in plan.tp}
        if plan.experts is not None:
            keep[plan.experts] = Shard(0)
        out[k] = one(p[k], keep)
    return out


def _routed_on_mesh(p, cfg: ArchConfig, x, act):
    """:func:`_routed` of the DTensor x (B, S, D) on each rank's tokens;
    a DTensor laid out as x, in the combine's dtype."""
    from torch.distributed.tensor import DTensor

    plan = _mesh_plan(p, x)
    B, S, D = x.shape
    xl = x.to_local(grad_placements=x.placements)
    Bl = xl.shape[0]
    if cfg.moe_group_by_batch:
        groups, group = xl, None
    else:
        groups, group = xl.reshape(1, Bl * S, D), B * S
    y = _routed(_local_weights(p, plan), cfg, groups, act, plan, group)
    return DTensor.from_local(y.reshape(Bl, S, D), plan.mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=(S * D, D, 1))


def moe_apply(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Routed FFN of x (B, S, D), plus the shared expert; x's dtype.  On
    a DTensor, each rank routes its own tokens under the global
    capacity (the module docstring)."""
    from torch.distributed.tensor import DTensor

    m = cfg.moe
    B, S, D = x.shape
    act = act_fn(cfg.ffn_act)
    if isinstance(x, DTensor):
        y = _routed_on_mesh(p, cfg, x, act).float()
    else:
        # a view either way: the routed path's gradient is summed there
        # before it meets the shared expert's, as on a mesh
        groups = x.view(B if cfg.moe_group_by_batch else 1, -1, D)
        y = _routed(p, cfg, groups, act).float().reshape(B, S, D)
    if m.n_shared:
        xt = x.reshape(B * S, D)
        g = act(dense(p["sh_gate"], xt).float())
        u = dense(p["sh_up"], xt).float()
        y = y + dense(p["sh_down"], (g * u).to(x.dtype)).float() \
            .reshape(B, S, D)
    return y.to(x.dtype)
