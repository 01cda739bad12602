"""Sharding plans and shape stand-ins for every (arch × shape) cell (the
port of the reference's ``launch/sharding.py``).

Training: params FSDP-on-``data`` × TP-on-``model`` (2D); ``pod`` is pure
DP (gradient all-reduce across pods).  Serving: params TP-on-``model``,
replicated over ``data`` (latency); batch sharded on (pod, data).  The
levers are the reference's: ``pure_dp`` (the model axis joins data
parallelism, no TP), ``seq_shard``, ``serve_fsdp`` and ``moe_ep_serve``.

Cache sharding picks the first *divisible* option per leaf:
  4D (B, X, Y, Z): heads/feature axis Y on model if divisible, else the
  seq/head axis X, else batch-only.  (kv_heads like 8 don't divide a
  16-wide model axis — those caches shard their seq dim instead; see
  DESIGN.md §6.)

Specs are :class:`~repro_torch.models.layers.Spec` tuples computed over
mesh axis names and sizes only: ``mesh`` may be a ``DeviceMesh`` or a
:class:`MeshShape`, so spec-level callers need no process group.
:func:`abstract_init` and :func:`cache_shapes` give shapes and dtypes
(:class:`ShapeDtype`) from ``FakeTensorMode``, allocating nothing.  The
reference's ``to_named`` is :func:`to_placements` (a spec tree to DTensor
placements) and :func:`distribute_tree` (full tensors, equal on every
rank, to DTensors: each rank keeps its own slice, no communication).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..configs import ShapeSpec
from ..models import transformer
from ..models.config import ArchConfig
from ..models.layers import Spec, map_specs, resolve_specs, spec_placements
from ..models.transformer import ShardCtx
from ..optim.tree import tree_map
from .mesh import mesh_axes


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices or process group:
    what the spec functions read of a mesh."""

    sizes: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size_of(self, name: str) -> int:
        return self.sizes[self.mesh_dim_names.index(name)]


@dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype (``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _size(mesh, name: str) -> int:
    if isinstance(mesh, MeshShape):
        return mesh.size_of(name)
    return mesh[name].size()


def _prod(mesh, axes) -> int:
    return math.prod(_size(mesh, a) for a in axes)


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


def _zip_map(fn, shapes, specs):
    """``fn(shape, spec)`` over a shape tree and its spec tree."""
    if isinstance(specs, Spec):
        return fn(shapes, specs)
    if isinstance(specs, dict):
        return {k: _zip_map(fn, shapes[k], v) for k, v in specs.items()}
    return type(specs)(_zip_map(fn, s, v) for s, v in zip(shapes, specs))


def _shape_tree(tree):
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), tree)


# ---------------------------------------------------------------------------
def _axes_for(cfg: ArchConfig, mesh):
    """(dp_axes, tensor_axis) honoring the pure_dp lever: with pure_dp the
    model axis joins data parallelism and no tensor axis remains.  Axes
    the mesh lacks (a :func:`layout_mesh` without ``model``) drop out."""
    dp, tensor, _ = mesh_axes(mesh)
    names = tuple(mesh.mesh_dim_names)
    if tensor not in names:
        tensor = None
    if cfg.pure_dp:
        return dp + ((tensor,) if tensor else ()), None
    return dp, tensor


def shard_ctx(cfg: ArchConfig, mesh) -> ShardCtx:
    dp, tensor = _axes_for(cfg, mesh)
    return ShardCtx(mesh=mesh, dp=dp, tensor=tensor,
                    seq_shard=cfg.seq_shard and tensor is not None)


def layout_mesh(cfg: ArchConfig, mesh, mode: str, batch: int):
    """The submesh of the axes a cell's layout uses, or ``None`` when it
    uses none.  An axis is used when a parameter spec or the batch's
    spec (``batch`` rows) names it, or when it is the TP axis; on an
    unused axis every rank holds and computes the same, as the
    reference's layout has it (a pure_dp batch of 256 on 2×16×16 covers
    pod × data only).  Running the step on the submesh keeps DTensor
    from spreading work over the idle axis by its own choice (where it
    would split a head or a token dim no spec splits)."""
    used = set()

    def note(s):
        for ax in s:
            if ax is not None:
                used.update(ax if isinstance(ax, tuple) else (ax,))
        return s

    map_specs(note, param_specs(cfg, mesh, mode))
    dp, tensor = _axes_for(cfg, mesh)
    used.update(_dp_for(batch, dp, mesh) or ())
    if tensor is not None:
        used.add(tensor)
    names = tuple(n for n in mesh.mesh_dim_names if n in used)
    if names == tuple(mesh.mesh_dim_names):
        return mesh
    if not names:
        return None
    return mesh[names]


def abstract_init(cfg: ArchConfig):
    """(param ShapeDtype tree, raw spec tree) without allocating anything:
    ``model_init`` runs under ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = transformer.model_init(0, cfg, device="cpu")
    return _shape_tree(params), transformer.model_specs(cfg)


def sanitize_specs(shapes, specs, mesh):
    """Drop mesh-axis assignments whose dimension isn't divisible.

    (e.g. hubert's 504-way vocab can't split over a 16-wide model axis;
    padded shards waste memory and FLOPs silently — explicit replication
    is preferred.)  Each spec comes out one entry a tensor dim."""

    def fix(shape, s):
        out = []
        for d, ax in enumerate(tuple(s) + (None,) * (shape.ndim - len(s))):
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            out.append(ax if shape.shape[d] % _prod(mesh, axes) == 0
                       else None)
        return Spec(out)

    return _zip_map(fix, shapes, specs)


def _ep(tree, lead: Tuple):
    """§Perf F2: expert-parallel serving — experts over data, the FFN dim
    over model (``lead``: a stacked leaf's layer axis)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("w_up", "w_gate") and _is_spec(v):
                tree[k] = Spec(lead + ("data", None, "model"))
            elif k == "w_down" and _is_spec(v):
                tree[k] = Spec(lead + ("data", "model", None))
            else:
                _ep(v, lead)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _ep(v, lead)


def param_specs(cfg: ArchConfig, mesh, mode: str):
    """Resolved spec tree for the params (mode: train|serve).

    ``serve_fsdp``: serve mode normally replicates over ``data`` for
    latency; models whose TP shard exceeds the device's memory shard
    weights over data too and pay a small per-layer collective instead."""
    _, tensor = _axes_for(cfg, mesh)
    fsdp = "data" if (mode == "train" or cfg.serve_fsdp) else None
    shapes, raw = abstract_init(cfg)
    resolved = resolve_specs(raw, tensor=tensor, fsdp=fsdp)
    if cfg.moe_ep_serve and mode == "serve":
        _ep(resolved.get("stack", ()), (None,))
        for sub in ("rem", "prefix"):
            if sub in resolved:
                _ep(resolved[sub], ())
    return sanitize_specs(shapes, resolved, mesh)


def param_shapes(cfg: ArchConfig):
    return abstract_init(cfg)[0]


def _dp_for(dim: int, dp, mesh):
    """Longest dp-axis prefix that divides ``dim`` (falls back toward
    ("data",), then replication) — e.g. pure_dp batch 32 on a 16×16 mesh
    shards over data only."""
    axes = list(dp)
    while axes:
        if dim % _prod(mesh, axes) == 0:
            return tuple(axes)
        axes.pop()
    return None


def _pick_cache_spec(dp, tensor, tp: int, mesh):
    def one(x: ShapeDtype) -> Spec:
        if x.ndim >= 5:                       # stacked (L, B, S, K, hd)
            inner = one(ShapeDtype(x.shape[1:], x.dtype))
            return Spec((None,) + tuple(inner))
        b = _dp_for(x.shape[0], dp, mesh)
        if x.ndim == 4:                       # (B, X, Y, Z)
            if x.shape[2] % tp == 0:
                return Spec((b, None, tensor, None))
            if x.shape[1] % tp == 0:
                return Spec((b, tensor, None, None))
            return Spec((b, None, None, None))
        if x.ndim == 3:                       # (B, W, R) conv state etc.
            if x.shape[2] % tp == 0:
                return Spec((b, None, tensor))
            return Spec((b, None, None))
        if x.ndim == 2:                       # (B, R)
            if x.shape[1] % tp == 0:
                return Spec((b, tensor))
            return Spec((b, None))
        return Spec((b,))
    return one


def cache_specs(cfg: ArchConfig, mesh, cache_shapes):
    dp, tensor = _axes_for(cfg, mesh)
    tp = _size(mesh, tensor) if tensor else 1
    return tree_map(_pick_cache_spec(dp, tensor, tp, mesh), cache_shapes)


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        cache = transformer.init_cache(cfg, batch, max_len, device="cpu")
    return _shape_tree(cache)


# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeSpec, mesh=None
                ) -> Dict[str, Any]:
    """ShapeDtype stand-ins for every model input of this cell.

    For ``train``: the token batch.  For ``prefill``: prompt batch + empty
    cache.  For ``decode``: one-token batch + full cache + cache_len.
    Nothing is allocated."""
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model

    def tok(b, s):
        return ShapeDtype((b, s), torch.int32)

    if shape.kind == "train":
        batch = {"tokens": tok(B, S), "labels": tok(B, S),
                 "mask": ShapeDtype((B, S), torch.float32)}
        if cfg.n_img_tokens:
            batch["image_embeds"] = ShapeDtype((B, cfg.n_img_tokens, D),
                                               torch.bfloat16)
        if cfg.audio_frontend:
            batch.pop("tokens")
            batch["frames"] = ShapeDtype((B, S, D), torch.bfloat16)
        return {"batch": batch}

    if shape.kind == "prefill":
        if cfg.encoder_only:
            # encoder "prefill" = one full forward encode of the batch
            return {"batch": {"frames": ShapeDtype((B, S, D),
                                                   torch.bfloat16)}}
        batch = {"tokens": tok(B, S)}
        if cfg.n_img_tokens:
            batch["image_embeds"] = ShapeDtype((B, cfg.n_img_tokens, D),
                                               torch.bfloat16)
        cache = cache_shapes(cfg.with_(decode_cache_len=S), B, S)
        return {"batch": batch, "cache": cache}

    # decode: one new token against a cache of seq_len
    cache = cache_shapes(cfg.with_(decode_cache_len=S), B, S)
    return {"batch": {"tokens": tok(B, 1)},
            "cache": cache,
            "cache_len": ShapeDtype((), torch.int32)}


def batch_specs_for(cfg: ArchConfig, mesh, batch):
    """Specs for a tree of batch leaves (tensors or ShapeDtypes): the
    leading dim over the longest dividing prefix of the dp axes."""
    dp, _ = _axes_for(cfg, mesh)

    def one(x) -> Spec:
        shape = tuple(x.shape)
        b = _dp_for(shape[0], dp, mesh) if shape else None
        if len(shape) >= 2:
            return Spec((b,) + (None,) * (len(shape) - 1))
        return Spec(())

    return tree_map(one, batch)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """Spec tree matching input_specs(...)['batch']."""
    return batch_specs_for(cfg, mesh, input_specs(cfg, shape, mesh)["batch"])


# ---------------------------------------------------------------------------
def to_placements(tree_specs, mesh):
    """A spec tree as a tree of DTensor placement lists on ``mesh`` (the
    reference's ``to_named``)."""
    return map_specs(lambda s: spec_placements(s, mesh), tree_specs)


def local_shape(shape, s, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor laid out by the
    resolved spec ``s`` (every sharded dim divisible, as
    :func:`sanitize_specs` leaves them)."""
    out = list(shape)
    for d, ax in enumerate(s):
        if ax is not None:
            out[d] //= _prod(mesh, ax if isinstance(ax, tuple) else (ax,))
    return tuple(out)


def local_bytes(shapes, specs, mesh) -> int:
    """Bytes of one rank's shards of a ShapeDtype tree under its specs."""
    total = 0

    def one(x: ShapeDtype, s):
        nonlocal total
        n = math.prod(local_shape(x.shape, s, mesh))
        total += n * torch.empty((), dtype=x.dtype).element_size()

    _zip_map(one, shapes, specs)
    return total


def distribute(t: torch.Tensor, placements, mesh):
    """A full tensor (equal on every rank) as a DTensor of ``placements``:
    each rank keeps its own slice (a copy, so the full tensor can be
    freed), with no communication.  A DTensor passes as it is."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(t, DTensor):
        return t
    local = t
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(md)
            size = local.shape[pl.dim] // n
            if size * n != local.shape[pl.dim]:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does "
                                 f"not divide over {n} ranks")
            local = local.narrow(pl.dim, mesh.get_local_rank(md) * size,
                                 size)
    stride = tuple(math.prod(t.shape[i + 1:]) for i in range(t.dim()))
    local = local.contiguous() if local is t else local.clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements,
                              run_check=False, shape=t.shape, stride=stride)


def distribute_tree(tree, specs, mesh):
    """:func:`distribute` over a tree of full tensors and its spec tree."""
    return _zip_map(lambda t, s: distribute(t, spec_placements(s, mesh),
                                            mesh), tree, specs)


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` as its full tensor (a collective:
    every rank of the mesh calls it)."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


__all__ = ["MeshShape", "ShapeDtype", "Spec", "abstract_init",
           "batch_specs", "cache_shapes", "cache_specs", "distribute",
           "distribute_tree", "gather_tree", "input_specs", "layout_mesh",
           "batch_specs_for",
           "local_bytes", "local_shape", "param_shapes", "param_specs",
           "sanitize_specs", "shard_ctx", "spec_placements", "to_placements"]
