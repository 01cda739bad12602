"""Primitive layers: parameter init and pure apply, on torch tensors.

The port of the reference's ``models/layers.py``.  Parameters are nested
dicts of tensors with the reference's names and layouts: a dense weight
is ``(d_in, d_out)`` and applies as ``x @ w`` (no transpose anywhere), an
embedding is ``(vocab, d)``.  Every ``*_init`` takes a ``torch.Generator``
on the target device and ``lead``, the leading shape of a stack of layers
(``()`` for one), and draws the reference's distributions (normal scaled
by ``d_in ** -0.5``, zero biases, unit f32 norm gains), not its bits.

**Sharding specs.**  Beside every ``*_init`` a ``*_specs`` function
returns the reference's spec tree for the same parameters, leaf for leaf
(the reference's ``*_init`` returns it as a second tree).  A
:class:`Spec` is a tuple with one entry per leading tensor dimension:
``None``, a mesh axis name, or a tuple of axis names.  Roles are logical:
:data:`TENSOR` is the TP mesh axis and :data:`FSDP` the FSDP one, resolved
to mesh axis names by :func:`resolve_specs` at launch
(``launch/sharding.py``), so the same model code serves one device, the
16x16 mesh and the 2x16x16 one.  Specs are plain data; no process group
or mesh is needed to build or resolve them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..optim.tree import shard_index, vocab_lookup

Params = Dict[str, Any]

# logical axis placeholders, resolved at launch
TENSOR = "__tensor__"
FSDP = "__fsdp__"


class Spec(tuple):
    """A sharding spec: one entry per leading tensor dimension (``None``,
    an axis name or a tuple of axis names); a tuple subclass, so a spec
    tree's leaves are told from its tuple nodes.  A one-axis tuple is
    stored as the axis itself, as ``PartitionSpec`` stores it."""

    def __new__(cls, axes=()):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def spec(*axes) -> Spec:
    return Spec(axes)


def map_specs(fn, tree):
    """``fn`` over the :class:`Spec` leaves of a spec tree, keeping its
    dicts, tuples and lists."""
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return tree


def resolve_specs(tree, *, tensor: Optional[str] = "model",
                  fsdp: Optional[str] = None):
    """Replace logical axis names with mesh axis names (or drop them)."""

    def fix(s: Spec) -> Spec:
        return Spec(tensor if ax == TENSOR else fsdp if ax == FSDP else ax
                    for ax in s)

    return map_specs(fix, tree)


def spec_placements(s, mesh) -> list:
    """The DTensor placements of a resolved spec on ``mesh``, one a mesh
    dim: an axis at tensor dim d is ``Shard(d)`` on that mesh dim, a tuple
    of axes ``Shard(d)`` on each of them, major first (as JAX orders
    them; the tuple must follow the mesh's dim order), an absent axis
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(s):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {s}: axes {axes} do not follow the "
                             f"mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {s}: mesh axis {names[i]} twice")
            out[i] = Shard(d)
    return out


def _normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float = 0.0,
               dtype: torch.dtype = torch.bfloat16,
               lead: Tuple[int, ...] = ()) -> Params:
    scale = scale or d_in ** -0.5
    p: Params = {"w": _normal(gen, lead + (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=gen.device)
    return p


def dense_specs(*, bias: bool = False, in_axis=FSDP,
                out_axis=TENSOR) -> Params:
    s: Params = {"w": spec(in_axis, out_axis)}
    if bias:
        s["b"] = spec(out_axis)
    return s


def fsdp_gathered(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w`` as a product with the activations ``x`` uses it: on a mesh,
    gathered over the mesh dims that shard ``x``'s batch (FSDP's
    all-gather before use, which the reference's activation shardings
    lead XLA to).  DTensor's own choice, the cheaper redistribution,
    would move a small activation onto a large weight's shards instead,
    and the product would hold the batch of every data rank: the loss's
    logits, a chunk of the sequence wide and the vocab long."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not (isinstance(w, DTensor) and isinstance(x, DTensor)):
        return w
    want = [Replicate() if xp == Shard(0) and isinstance(wp, Shard) else wp
            for xp, wp in zip(x.placements, w.placements)]
    return (w if want == list(w.placements)
            else w.redistribute(w.device_mesh, want))


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ fsdp_gathered(p["w"], x)
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, *, device: torch.device,
                 lead: Tuple[int, ...] = ()) -> Params:
    return {"g": torch.ones(lead + (d,), dtype=torch.float32, device=device)}


def rmsnorm_specs() -> Params:
    return {"g": spec(None)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In f32 with an f32 gain, cast back to x's dtype."""
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["g"]).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.bfloat16) -> Params:
    return {"e": _normal(gen, (vocab, d), d ** -0.5, dtype)}


def embed_specs() -> Params:
    return {"e": spec(TENSOR, FSDP)}      # vocab-sharded


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(p["e"], DTensor):
        return _embed_sharded(p["e"], ids)
    return F.embedding(ids, p["e"])


def _embed_sharded(e, ids):
    """The lookup on a DTensor table, vocab-parallel
    (:func:`~repro_torch.optim.tree.vocab_lookup`: every rank looks its
    ids up in its own vocab rows).  Any other sharding of the table (FSDP
    on d) is gathered first; the ids keep their batch sharding and are
    replicated over the vocab dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = e.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    vocab = [pl == Shard(0) and e.shape[0] % mesh.size(md) == 0
             for md, pl in enumerate(e.placements)]
    id_pl = [Replicate() if v or not isinstance(pl, Shard) else pl
             for v, pl in zip(vocab, ids.placements)]
    el = e.redistribute(mesh, [Shard(0) if v else Replicate()
                               for v in vocab]).to_local(grad_placements=[
        Shard(0) if v else Partial() if isinstance(ip, Shard)
        else Replicate() for v, ip in zip(vocab, id_pl)])
    il = ids.redistribute(mesh, id_pl).to_local()
    return vocab_lookup(lambda rows: F.embedding(rows, el), il, el.shape[0],
                        mesh, vocab, id_pl, tuple(ids.shape) + (e.shape[1],))


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits over the vocab."""
    return x @ fsdp_gathered(p["e"], x).T


def split_heads(shd, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,H·hd) -> (B,S,H,hd), through the model's ``ShardCtx`` where
    there is one (its ``split_heads`` keeps each head on one rank)."""
    if shd is not None:
        return shd.split_heads(x, n_heads)
    return x.reshape(*x.shape[:2], n_heads, x.shape[2] // n_heads)


def merge_heads(shd, x: torch.Tensor) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,H·hd), through the model's ``ShardCtx`` where
    there is one (its ``merge_heads``)."""
    if shd is not None:
        return shd.merge_heads(x)
    return x.reshape(*x.shape[:2], -1)


def write_into(dst: torch.Tensor, src: torch.Tensor, dim: Optional[int] = None,
               start: int = 0) -> None:
    """In place: ``dst.narrow(dim, start, n).copy_(src)``, ``n`` src's
    size in ``dim`` (the whole of ``dst`` when ``dim`` is None) — the
    caches' writes.  On a DTensor ``dst`` every rank writes its own shard:
    ``src`` is laid out as ``dst``, gathered along ``dim`` where ``dst``
    shards it, and each rank copies the part of ``[start, start + n)``
    that falls in its own range.  (A write through a DTensor slice would
    land in a redistributed copy where the slice cuts a sharded dim.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(dst, DTensor):
        (dst if dim is None else dst.narrow(dim, start, src.shape[dim])
         ).copy_(src)
        return
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    cut = [dim is not None and pl == Shard(dim) for pl in dst.placements]
    want = [Replicate() if c else pl for c, pl in zip(cut, dst.placements)]
    if list(src.placements) != want:
        src = src.redistribute(mesh, want)
    d_loc, s_loc = dst.to_local(), src.to_local()
    if dim is None:
        d_loc.copy_(s_loc)
        return
    lo = shard_index(mesh, cut)[0] * d_loc.shape[dim]
    a = max(start, lo)
    b = min(start + s_loc.shape[dim], lo + d_loc.shape[dim])
    if a < b:
        d_loc.narrow(dim, a - lo, b - a).copy_(
            s_loc.narrow(dim, a - start, b - a))


# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim, rotating the split halves (not
    interleaved pairs), in f32 and cast back.  x: (..., S, H, hd),
    positions (S,) or (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]
