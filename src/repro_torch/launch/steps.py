"""Step factories: train_step / prefill_step / decode_step.

The port of the reference's ``launch/steps.py``.  With ``mesh=None`` the
steps run on one device.  With a mesh (``launch/mesh.py``) they take
DTensors laid out by ``launch/sharding.py`` (a plain batch is laid out
by the train step) and run the model under the reference's activation
sharding (``models/transformer.py``'s ``ShardCtx``): every rank runs the
same program on its shards and DTensor inserts the collectives.  The
gradients come back laid out as the parameters (a partial sum reduced,
a replicated one all-reduced), so AdamW updates each rank's shards in
place.  ``grad_compress`` on a mesh with a ``pod`` axis sends the reduced
gradient through the int8 quantizer's round trip (``optim/compress.py``,
one global scale a leaf), as the reference does; with no pod axis it
changes nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models import lm, transformer
from ..models.config import ArchConfig
from ..models.transformer import NO_SHARD, ShardCtx
from ..optim import adamw_update
from ..optim.compress import compress_grads_int8, decompress_grads_int8
from ..optim.tree import leaves, tree_map
from .mesh import mesh_axes


def _shd(cfg: ArchConfig, mesh) -> Optional[ShardCtx]:
    """The step's ``ShardCtx``; a ``mesh`` that is not a ``DeviceMesh``
    raises ``TypeError``, a config with MoE layers
    ``NotImplementedError`` (ROADMAP A19b)."""
    from torch.distributed.device_mesh import DeviceMesh

    from .sharding import shard_ctx

    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh, got {type(mesh)}")
    if any(ls.ffn == "moe" for ls in cfg.period):
        raise NotImplementedError(
            f"{cfg.name}: the MoE dispatch does not run on a mesh yet "
            f"(ROADMAP A19b)")
    return shard_ctx(cfg, mesh)


def _as_param_layout(g, p):
    """A gradient laid out as its parameter (DTensor placements)."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                   shd: Optional[ShardCtx] = None):
    """(loss, grads): ``lm.loss_fn`` and, by autograd, its gradient with
    respect to every parameter leaf (zeros for a leaf the loss does not
    reach), in a tree shaped like ``params`` — ``jax.value_and_grad``'s
    result.  On DTensors each gradient is laid out as its parameter."""
    flat = leaves(params)
    with torch.enable_grad(), (shd or NO_SHARD).scope():
        for p in flat:
            p.requires_grad_(True)
        loss = lm.loss_fn(params, cfg, batch, shd)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
        by_id = {id(p): (torch.zeros_like(p) if g is None
                         else _as_param_layout(g, p))
                 for p, g in zip(flat, got)}
    loss = loss.detach()
    if hasattr(loss, "full_tensor"):           # a DTensor's partial sum
        loss = loss.full_tensor()
    return loss, tree_map(lambda p: by_id[id(p)], params)


def make_train_step(cfg: ArchConfig, mesh=None, *, lr: float = 3e-4,
                    grad_compress: bool = False):
    """(params, opt, batch) -> (params, opt, {"loss", "gnorm"}): the loss
    and every parameter's gradient (:func:`loss_and_grads`), then AdamW,
    which updates ``params`` and ``opt``'s moments in place
    (``optim/adamw.py``).  The metrics stay on the device.  On a mesh, a
    plain batch is laid out by the reference's batch specs first."""
    shd = _shd(cfg, mesh)
    pod = mesh_axes(mesh)[2] if mesh is not None else None

    def train_step(params, opt, batch: Dict[str, torch.Tensor]):
        if mesh is not None:
            from .sharding import batch_specs_for, distribute_tree

            batch = distribute_tree(batch, batch_specs_for(cfg, mesh, batch),
                                    mesh)
        loss, grads = loss_and_grads(params, cfg, batch, shd)
        if grad_compress and pod is not None:
            # int8 compression of the pod-axis gradient traffic: the
            # reduced gradient's quantize / dequantize round trip
            q, s, _ = compress_grads_int8(grads)
            grads = decompress_grads_int8(q, s)
        params, opt, gnorm = adamw_update(params, grads, opt, lr=lr)
        return params, opt, {"loss": loss, "gnorm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh=None):
    shd = _shd(cfg, mesh)

    if cfg.encoder_only:
        @torch.no_grad()
        def encode_step(params, batch):
            logits, _ = transformer.model_apply(params, cfg, batch,
                                                mode="train", shd=shd)
            return logits
        return encode_step

    prefill = lm.make_prefill(cfg, shd)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return prefill(params, batch, cache)

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):
    decode = lm.make_decode_step(cfg, _shd(cfg, mesh))

    @torch.no_grad()
    def decode_step(params, cache, cache_len, batch: Dict[str, Any]):
        nxt, _, new_cache = decode(params, cache, cache_len,
                                   batch["tokens"])
        return nxt, new_cache

    return decode_step
