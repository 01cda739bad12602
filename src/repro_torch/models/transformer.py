"""Transformer assembly: blocks, stacks of periods, caches.

The port of the reference's ``models/transformer.py``, for all ten of its
configurations: ``full`` and ``local`` attention mixers, cross-attention
layers (``lspec.cross_attn``, the VLM's; ``models/attention.py``), the
``mla`` mixer (``models/mla.py``), the ``rglru`` and ``rwkv6`` recurrent
mixers (``models/recurrent.py``), with ``glu``, ``mlp``, ``moe``
(``models/moe.py``) or ``rwkv_cm`` FFNs.  The parameter tree keeps the
reference's layout: ``params["prefix"]`` (deepseek's dense first layer:
a block of ``period[0]``'s mixer with a GLU FFN of ``first_layer_ffn``,
applied before the stack), ``params["stack"][j]`` holding period slot
``j`` of all ``n_full_periods`` full periods stacked on a leading axis
(layer ``i·len(period) + j`` is index ``i`` there), then
``params["rem"]`` the remainder layers; ``embed`` unless the model takes
frame embeddings (``audio_frontend``: HuBERT reads ``batch["frames"]``),
``head`` when it has an untied one.  The cache mirrors it, a block's
cache being ``{"mixer": ..., "ffn": ...}`` (K/V, MLA's ``{"c", "kr"}``,
``{"h", "conv"}`` or ``{"state", "x_prev"}``; ``{"x_prev"}`` for
``rwkv_cm``, else ``{}``), ``cache["prefix"]`` the prefix's (``{}``
without one).  The VLM's cross layers attend ``batch["image_embeds"]``.
The model runs the stack as a Python loop over periods (the reference's
``lax.scan``; ``use_scan`` changes nothing).  With ``cfg.remat``, a
train-mode forward under autograd runs each full period's body under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(body)``):
only the period's input is kept, and the body runs again in the backward
pass, so a kernel it launches counts a second launch there.  With
``cfg.attn_remat`` too, the blockwise attention runs each chunk pair
under a checkpoint of its own (``models/attention.py``), and the two
levels nest, both non-reentrant: the period's recompute re-enters each
pair's checkpoint, and the pair's backward recomputes its scores once
more — the reference's ``jax.checkpoint(body)`` around
``jax.checkpoint(step)``.  Without a gradient neither flag changes
anything.

**Sharding.**  :func:`model_specs` is the reference's spec tree for
``model_init``'s parameters (``launch/sharding.py`` resolves it).  With a
:class:`ShardCtx` over a mesh, ``model_apply`` runs on DTensors (the
parameters and the batch distributed by ``launch/sharding.py``) and pins
the residual stream, the attention heads and the logits to the
reference's placements, redistributing where they differ; every other
op's placement is DTensor's sharding propagation, and the kernels run
on each rank's local shards (``kernels/_sharded.py``).  Without a mesh
``ShardCtx`` does nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..core.batched_pq import resolve_device
from . import attention, mla, moe, recurrent
from .config import ArchConfig, LayerSpec
from .layers import (FSDP, TENSOR, Spec, act_fn, dense, dense_init,
                     dense_specs, embed, embed_init, embed_specs, map_specs,
                     rmsnorm, rmsnorm_init, rmsnorm_specs, softcap,
                     spec_placements, unembed, write_into)

# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardCtx:
    """Activation sharding (the reference's ``ShardCtx``): with a mesh,
    each method redistributes a DTensor to the reference's placement;
    ``mesh=None`` (one device) is a no-op, and so is a plain tensor."""

    mesh: Any = None
    dp: Tuple[str, ...] = ("data",)
    tensor: Optional[str] = "model"
    seq_shard: bool = False

    def scope(self):
        """The context a sharded forward and backward run in: plain tensors
        made inside the model (positions, masks, zero states) count as
        replicated DTensors.  Re-entrant (DTensor's own
        ``implicit_replication`` clears the flag on exit, even nested);
        the flag is thread-local and autograd carries it to its worker
        threads."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return _implicit_replication()

    def _dp_fit(self, dim: int):
        """Longest dp prefix dividing ``dim`` (pure_dp prefill batches may
        not cover data×model — fall back to data, then replicate)."""
        axes = list(self.dp)
        while axes:
            size = math.prod(self.mesh[a].size() for a in axes)
            if dim % size == 0:
                return tuple(axes)
            axes.pop()
        return None

    def _pin(self, x, s):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        if self.mesh is None or not isinstance(x, DTensor):
            return x
        want = spec_placements(Spec(s), self.mesh)
        if list(x.placements) != want:
            if any(isinstance(p, Partial) for p in x.placements):
                # reduce a partial sum (e.g. a vocab-sharded lookup's)
                # first, then lay it out
                x = x.redistribute(self.mesh, [
                    Replicate() if isinstance(p, Partial) else p
                    for p in x.placements])
            x = x.redistribute(self.mesh, want)
        return x

    def act(self, x):
        """Residual stream (B,S,D)."""
        if self.mesh is None:
            return x
        seq = self.tensor if (self.seq_shard and x.shape[1] > 1) else None
        return self._pin(x, (self._dp_fit(x.shape[0]), seq, None))

    def whole_seq(self, x):
        """A mixer's, FFN's or the head's input (B,S,D): with
        ``seq_shard`` the residual stream's sequence shards gathered
        (sequence parallelism: the norms run on the shards, the
        projections on the whole sequence, and :meth:`act` scatters each
        output again before it joins the residual stream — so the
        backward's gradients reach the projections whole too)."""
        if self.mesh is None or not self.seq_shard:
            return x
        return self._pin(x, (self._dp_fit(x.shape[0]), None, None))

    def _head_axis(self, n_heads: int):
        if self.tensor is None:
            return None
        return (self.tensor if n_heads % self.mesh[self.tensor].size() == 0
                else None)

    def heads(self, x):
        """Attention tensors (B,S,H,hd): heads on the tensor axis when
        divisible, else batch-only (replicated heads)."""
        if self.mesh is None or self.tensor is None or x.dim() != 4:
            return x
        return self._pin(x, (self._dp_fit(x.shape[0]), None,
                             self._head_axis(x.shape[2]), None))

    def split_heads(self, x, n_heads: int):
        """(B,S,H·hd) -> (B,S,H,hd).  On a mesh the flat tensor is first
        pinned to :meth:`heads`'s placement, so the split never cuts a
        head across ranks (a DTensor view cannot)."""
        B, S, F = x.shape
        if self.mesh is not None:
            x = self._pin(x, (self._dp_fit(B), None,
                              self._head_axis(n_heads)))
        return x.reshape(B, S, n_heads, F // n_heads)

    def logits(self, x):
        if self.mesh is None:
            return x
        return self._pin(x, (self._dp_fit(x.shape[0]), None, self.tensor))


NO_SHARD = ShardCtx()


@contextlib.contextmanager
def _implicit_replication():
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)


# mixer kind -> (init, apply)
_MIXERS = {
    "full": (attention.attn_init, attention.attn_apply),
    "local": (attention.attn_init, attention.attn_apply),
    "mla": (mla.mla_init, mla.mla_apply),
    "rglru": (recurrent.rglru_init, recurrent.rglru_apply),
    "rwkv6": (recurrent.rwkv6_init, recurrent.rwkv6_apply),
}
_FFNS = ("glu", "mlp", "moe", "rwkv_cm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` on a mixer or FFN kind the model does not
    know."""
    for lspec in cfg.period:
        for kind, known in ((lspec.mixer, _MIXERS), (lspec.ffn, _FFNS)):
            if kind not in known:
                raise ValueError(f"{cfg.name}: unknown layer kind {kind!r}")


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------
def ffn_init(gen: torch.Generator, cfg: ArchConfig, lspec: LayerSpec,
             d_ff: int = 0, *, lead: Tuple[int, ...] = ()):
    if lspec.ffn == "moe":
        return moe.moe_init(gen, cfg, lead=lead)
    if lspec.ffn == "rwkv_cm":
        return recurrent.rwkv_cm_init(gen, cfg, lead=lead)
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    p = {"up": dense_init(gen, D, F, lead=lead),
         "down": dense_init(gen, F, D, lead=lead)}
    if lspec.ffn == "glu":
        p["gate"] = dense_init(gen, D, F, lead=lead)
    return p


def ffn_specs(cfg: ArchConfig, lspec: LayerSpec):
    if lspec.ffn == "moe":
        return moe.moe_specs(cfg)
    if lspec.ffn == "rwkv_cm":
        return recurrent.rwkv_cm_specs(cfg)
    s = {"up": dense_specs(), "down": dense_specs(in_axis=TENSOR,
                                                  out_axis=FSDP)}
    if lspec.ffn == "glu":
        s["gate"] = dense_specs()
    return s


def ffn_apply(p, cfg: ArchConfig, lspec: LayerSpec, x, *, cache=None,
              mode="train"):
    """GLU or MLP, the activation in f32, cast back before ``down``; the
    MoE; or the RWKV channel mix (its ``cache`` updated in place)."""
    if lspec.ffn == "moe":
        return moe.moe_apply(p, cfg, x)
    if lspec.ffn == "rwkv_cm":
        return recurrent.rwkv_cm_apply(p, cfg, x, cache=cache, mode=mode)
    act = act_fn(cfg.ffn_act)
    if lspec.ffn == "glu":
        h = act(dense(p["gate"], x).float()) * dense(p["up"], x).float()
    else:
        h = act(dense(p["up"], x).float())
    return dense(p["down"], h.to(x.dtype))


# ---------------------------------------------------------------------------
# Block = mixer + ffn with pre-(and optionally post-)norms
# ---------------------------------------------------------------------------
def block_init(gen: torch.Generator, cfg: ArchConfig, lspec: LayerSpec,
               d_ff: int = 0, *, lead: Tuple[int, ...] = ()):
    dev = gen.device
    init_fn, _ = _MIXERS[lspec.mixer]
    p = {"n1": rmsnorm_init(cfg.d_model, device=dev, lead=lead),
         "mixer": init_fn(gen, cfg, lspec, lead=lead),
         "n2": rmsnorm_init(cfg.d_model, device=dev, lead=lead),
         "ffn": ffn_init(gen, cfg, lspec, d_ff, lead=lead)}
    if cfg.post_norm:
        p["pn1"] = rmsnorm_init(cfg.d_model, device=dev, lead=lead)
        p["pn2"] = rmsnorm_init(cfg.d_model, device=dev, lead=lead)
    return p


_MIXER_SPECS = {"full": attention.attn_specs, "local": attention.attn_specs,
                "mla": mla.mla_specs, "rglru": recurrent.rglru_specs,
                "rwkv6": recurrent.rwkv6_specs}


def block_specs(cfg: ArchConfig, lspec: LayerSpec):
    s = {"n1": rmsnorm_specs(), "mixer": _MIXER_SPECS[lspec.mixer](cfg, lspec),
         "n2": rmsnorm_specs(), "ffn": ffn_specs(cfg, lspec)}
    if cfg.post_norm:
        s["pn1"] = rmsnorm_specs()
        s["pn2"] = rmsnorm_specs()
    return s


def block_apply(p, cfg: ArchConfig, lspec: LayerSpec, x, *, positions,
                ctx=None, cache=None, cache_len=None, mode="train",
                shd: ShardCtx = NO_SHARD):
    """One block; in prefill and decode mode ``cache`` (the block's) is
    updated in place.  ``ctx``: what a cross-attention layer attends."""
    _, apply_fn = _MIXERS[lspec.mixer]
    h = shd.act(apply_fn(p["mixer"], cfg, lspec,
                         shd.whole_seq(rmsnorm(p["n1"], x)),
                         positions=positions, ctx=ctx,
                         cache=cache["mixer"] if cache else None,
                         cache_len=cache_len, mode=mode, shd=shd))
    if cfg.post_norm:
        h = rmsnorm(p["pn1"], h)
    x = x + h
    h = shd.act(ffn_apply(p["ffn"], cfg, lspec,
                          shd.whole_seq(rmsnorm(p["n2"], x)),
                          cache=cache["ffn"] if cache else None, mode=mode))
    if cfg.post_norm:
        h = rmsnorm(p["pn2"], h)
    return shd.act(x + h)


def block_cache_init(cfg: ArchConfig, lspec: LayerSpec, batch: int,
                     max_len: int, dtype: torch.dtype = torch.bfloat16, *,
                     device: torch.device, lead: Tuple[int, ...] = ()):
    """A block's cache: K/V, ``{"c", "kr"}``, ``{"h", "conv"}`` or
    ``{"state", "x_prev"}`` for the mixer, ``{"x_prev"}`` for ``rwkv_cm``.
    K/V, MLA's latents, ``conv`` and ``x_prev`` in ``dtype``; the
    recurrent states in f32."""
    kw = dict(device=device, lead=lead)
    if lspec.mixer == "mla":
        mix = mla.mla_cache_init(cfg, batch, max_len, dtype, **kw)
    elif lspec.mixer == "rglru":
        mix = recurrent.rglru_cache_init(cfg, batch, dtype, **kw)
    elif lspec.mixer == "rwkv6":
        mix = recurrent.rwkv6_cache_init(cfg, batch, dtype, **kw)
    else:
        mix = attention.attn_cache_init(cfg, lspec, batch, max_len, dtype,
                                        **kw)
    ffn = (recurrent.rwkv_cm_cache_init(cfg, batch, dtype, **kw)
           if lspec.ffn == "rwkv_cm" else {})
    return {"mixer": mix, "ffn": ffn}


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
def _index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so in-place cache writes land
    in the stack."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _layers_whole(stack):
    """(work, commit): a stacked cache whose DTensor leaves shard their
    layer axis (the reference's cache specs read a stacked (L, B, R) leaf
    as (B, W, R) and may put L on a dp axis) gathered along it, so that
    ``_index`` gives views a write lands in; ``commit()`` writes them
    back.  Other leaves pass as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    back = []

    def one(t):
        if not (isinstance(t, DTensor) and Shard(0) in t.placements):
            return t
        w = t.redistribute(t.device_mesh, [
            Replicate() if p == Shard(0) else p for p in t.placements])
        back.append((t, w))
        return w

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(walk(v) for v in t)
        return one(t)

    work = walk(stack)

    def commit():
        for t, w in back:
            write_into(t, w)

    return work, commit


def _prefix_spec(cfg: ArchConfig) -> LayerSpec:
    """The dense first layer's spec: ``period[0]`` with a GLU FFN."""
    return dataclasses.replace(cfg.period[0], ffn="glu")


def model_init(key: Union[int, torch.Generator], cfg: ArchConfig, *,
               device=None) -> Dict[str, Any]:
    """Random weights of the reference's distributions, drawn from a
    ``torch.Generator`` (``key`` is one, or the seed of one on
    ``device``; ``None`` means the card).  bf16 weights and embeddings,
    f32 norm gains, zero biases.  Returns the parameter tree (the
    reference also returns sharding specs; the port has none)."""
    check_supported(cfg)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(key))
    dev = gen.device
    p: Dict[str, Any] = {}
    if not cfg.audio_frontend:
        p["embed"] = embed_init(gen, cfg.vocab, cfg.d_model)
    if cfg.n_prefix:
        p["prefix"] = block_init(gen, cfg, _prefix_spec(cfg),
                                 d_ff=cfg.first_layer_ffn)
    n_full = cfg.n_full_periods
    p["stack"] = tuple(block_init(gen, cfg, lspec, lead=(n_full,))
                       for lspec in cfg.period) if n_full > 0 else ()
    p["rem"] = tuple(block_init(gen, cfg, cfg.period[j % len(cfg.period)])
                     for j in range(cfg.n_remainder))
    p["final_norm"] = rmsnorm_init(cfg.d_model, device=dev)
    if cfg.audio_frontend or not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab)
    return p


def model_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The reference's raw spec tree (logical :data:`~.layers.TENSOR` /
    :data:`~.layers.FSDP` roles) for :func:`model_init`'s parameters, leaf
    for leaf; a stacked leaf's spec leads with ``None`` for its layer
    axis."""
    check_supported(cfg)
    s: Dict[str, Any] = {}
    if not cfg.audio_frontend:
        s["embed"] = embed_specs()
    if cfg.n_prefix:
        s["prefix"] = block_specs(cfg, _prefix_spec(cfg))
    s["stack"] = tuple(
        map_specs(lambda sp: Spec((None,) + tuple(sp)), block_specs(cfg, ls))
        for ls in cfg.period) if cfg.n_full_periods > 0 else ()
    s["rem"] = tuple(block_specs(cfg, cfg.period[j % len(cfg.period)])
                     for j in range(cfg.n_remainder))
    s["final_norm"] = rmsnorm_specs()
    if cfg.audio_frontend or not cfg.tie_embeddings:
        s["head"] = dense_specs(in_axis=FSDP, out_axis=TENSOR)
    return s


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               dtype: torch.dtype = torch.bfloat16, device=None):
    """Decode/prefill cache tree mirroring the param layout (K/V, MLA's
    latents, the RG-LRU conv history and the RWKV token-shift inputs in
    ``dtype``, bf16 as in the reference; the recurrent states in f32)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n_full = cfg.n_full_periods
    stack = tuple(block_cache_init(cfg, lspec, batch, max_len, dtype,
                                   device=dev, lead=(n_full,))
                  for lspec in cfg.period) if n_full > 0 else ()
    rem = tuple(block_cache_init(cfg, cfg.period[j % len(cfg.period)],
                                 batch, max_len, dtype, device=dev)
                for j in range(cfg.n_remainder))
    prefix = (block_cache_init(cfg, cfg.period[0], batch, max_len, dtype,
                               device=dev) if cfg.n_prefix else {})
    return {"stack": stack, "rem": rem, "prefix": prefix}


def embed_input(params, cfg: ArchConfig,
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The stack's input (B, S, D): HuBERT's ``batch["frames"]``, else the
    embedding of ``batch["tokens"]``, scaled by sqrt(d_model) when
    ``scale_embed``."""
    if cfg.audio_frontend:
        return batch["frames"]
    x = embed(params["embed"], batch["tokens"])
    if cfg.scale_embed:
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    return x


def model_apply(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
                mode: str = "train", shd: Optional[ShardCtx] = None,
                cache=None, cache_len: Optional[int] = None):
    """Returns (logits, cache).  mode="train_hidden" skips the unembed and
    returns the final hidden states (the chunked-loss path).  In prefill
    and decode mode the cache is updated in place and returned;
    ``cache_len`` (a Python int) is the number of tokens already in it.
    ``shd``: the activation sharding (:class:`ShardCtx`; none by
    default)."""
    shd = shd or NO_SHARD
    with shd.scope():
        return _model_apply(params, cfg, batch, mode, shd, cache, cache_len)


def _model_apply(params, cfg, batch, mode, shd, cache, cache_len):
    check_supported(cfg)
    return_hidden = mode == "train_hidden"
    if return_hidden:
        mode = "train"
    x = shd.act(embed_input(params, cfg, batch))
    S = x.shape[1]
    if mode == "decode":
        positions = torch.full((1,), cache_len, dtype=torch.int64,
                               device=x.device)
    else:
        positions = torch.arange(S, device=x.device)
    kw = dict(positions=positions, ctx=batch.get("image_embeds"),
              cache_len=cache_len, mode=mode, shd=shd)

    if cfg.n_prefix:
        x = block_apply(params["prefix"], cfg, _prefix_spec(cfg), x,
                        cache=cache["prefix"] if cache is not None else None,
                        **kw)
    stack, commit = (_layers_whole(cache["stack"]) if cache is not None
                     else (None, None))

    def period(x, i):
        for j, lspec in enumerate(cfg.period):
            cj = _index(stack[j], i) if cache is not None else None
            x = block_apply(_index(params["stack"][j], i), cfg, lspec, x,
                            cache=cj, **kw)
        return x

    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for i in range(cfg.n_full_periods):
        x = (checkpoint(period, x, i, use_reentrant=False) if remat
             else period(x, i))
    if commit is not None:
        commit()
    for j in range(cfg.n_remainder):
        lspec = cfg.period[j % len(cfg.period)]
        cj = cache["rem"][j] if cache is not None else None
        x = block_apply(params["rem"][j], cfg, lspec, x, cache=cj, **kw)

    x = shd.whole_seq(rmsnorm(params["final_norm"], x))
    if return_hidden:
        return x, None                     # chunked-loss path: no logits here
    if "head" in params:
        logits = dense(params["head"], x)
    else:
        logits = unembed(params["embed"], x)
    logits = shd.logits(softcap(logits.float(), cfg.logit_softcap))
    if mode == "train":
        return logits, None
    return logits, cache


def count_params(params) -> int:
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                yield from leaves(v)
        else:
            yield t
    return sum(int(x.numel()) for x in leaves(params))
