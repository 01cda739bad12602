"""Step factories: train_step / prefill_step / decode_step.

The port of the reference's ``launch/steps.py`` for one device: ``mesh``
must be ``None`` (a mesh raises ``NotImplementedError``: a sharded step
needs the reference's param specs, ``launch/sharding.py``, ROADMAP
A19).  ``grad_compress`` routes only the cross-pod gradient reduction
through the int8 quantizer in the reference, so with no pod axis it
changes nothing here either.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import lm, transformer
from ..models.config import ArchConfig
from ..optim import adamw_update
from ..optim.tree import leaves, tree_map


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port trains on one device: a mesh needs launch/sharding.py's "
            "param specs (ROADMAP A19)")


def loss_and_grads(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """(loss, grads): ``lm.loss_fn`` and, by autograd, its gradient with
    respect to every parameter leaf (zeros for a leaf the loss does not
    reach), in a tree shaped like ``params`` — ``jax.value_and_grad``'s
    result."""
    flat = leaves(params)
    with torch.enable_grad():
        for p in flat:
            p.requires_grad_(True)
        loss = lm.loss_fn(params, cfg, batch)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g)
             for p, g in zip(flat, got)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], params)


def make_train_step(cfg: ArchConfig, mesh=None, *, lr: float = 3e-4,
                    grad_compress: bool = False):
    """(params, opt, batch) -> (params, opt, {"loss", "gnorm"}): the loss
    and every parameter's gradient (:func:`loss_and_grads`), then AdamW,
    which updates ``params`` and ``opt``'s moments in place
    (``optim/adamw.py``).  The metrics stay on the device."""
    _no_mesh(mesh)

    def train_step(params, opt, batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(params, cfg, batch)
        params, opt, gnorm = adamw_update(params, grads, opt, lr=lr)
        return params, opt, {"loss": loss, "gnorm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh=None):
    _no_mesh(mesh)

    if cfg.encoder_only:
        @torch.no_grad()
        def encode_step(params, batch):
            logits, _ = transformer.model_apply(params, cfg, batch,
                                                mode="train")
            return logits
        return encode_step

    prefill = lm.make_prefill(cfg)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return prefill(params, batch, cache)

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):
    _no_mesh(mesh)
    decode = lm.make_decode_step(cfg)

    @torch.no_grad()
    def decode_step(params, cache, cache_len, batch: Dict[str, Any]):
        nxt, _, new_cache = decode(params, cache, cache_len,
                                   batch["tokens"])
        return nxt, new_cache

    return decode_step
