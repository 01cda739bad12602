"""LM heads: the loss, and the prefill and decode step factories.

The port of the reference's ``models/lm.py``.  The batch dict reaches
``model_apply`` as it is: ``tokens`` (or HuBERT's ``frames``),
``labels``, ``mask`` and the VLM's ``image_embeds``.  ``lm_loss_chunked`` is a
loop over sequence chunks, the reference's checkpointed ``lax.scan``:
under autograd each chunk's cross-entropy runs under
``torch.utils.checkpoint``, so no chunk's logits outlive it and the
backward pass recomputes them; ``cfg.loss_chunk`` picks it in
:func:`loss_fn`, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .config import ArchConfig
from .layers import dense, softcap, unembed
from ..optim.tree import vocab_lookup
from .transformer import NO_SHARD, ShardCtx, model_apply


def label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``.  On DTensor logits every rank takes the
    labels that fall in its own vocab columns
    (:func:`~repro_torch.optim.tree.vocab_lookup`).  The other dims keep
    the logits' sharding, and the labels are laid out to match."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    mesh = logits.device_mesh
    last = logits.dim() - 1
    lg_pl = [Replicate() if isinstance(p, Partial) else p
             for p in logits.placements]
    vocab = [p == Shard(last) for p in lg_pl]
    lab_pl = [p if isinstance(p, Shard) and p.dim < last else Replicate()
              for p in lg_pl]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    lg = logits.redistribute(mesh, lg_pl).to_local(grad_placements=lg_pl)
    lab = labels.redistribute(mesh, lab_pl).to_local().long()
    return vocab_lookup(
        lambda cols: torch.gather(lg, -1, cols[..., None])[..., 0], lab,
        lg.shape[-1], mesh, vocab, lab_pl, tuple(logits.shape[:-1]))


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) f32, labels (B,S) ints."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - label_logits(logits, labels)
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _fused_chunk_xent(params, cfg: ArchConfig, x_c, y_c, m_c):
    """Cross-entropy over one seq chunk without materializing the full
    logits outside the chunk: (sum of masked nll, sum of the mask)."""
    if "head" in params:
        logits = dense(params["head"], x_c)
    else:
        logits = unembed(params["embed"], x_c)
    logits = softcap(logits.float(), cfg.logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    return ((lse - label_logits(logits, y_c)) * m_c).sum(), m_c.sum()


def lm_loss_chunked(params, cfg: ArchConfig, x: torch.Tensor, labels, mask,
                    chunk: int) -> torch.Tensor:
    B, S, D = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for c in range((S + pad) // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (params, cfg, x[:, sl], labels[:, sl], mask[:, sl])
        s_nll, s_cnt = (checkpoint(_fused_chunk_xent, *args,
                                   use_reentrant=False) if remat
                        else _fused_chunk_xent(*args))
        nll = nll + s_nll
        cnt = cnt + s_cnt
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            shd: Optional[ShardCtx] = None) -> torch.Tensor:
    if cfg.loss_chunk:
        x, _ = model_apply(params, cfg, batch, mode="train_hidden", shd=shd)
        with (shd or NO_SHARD).scope():
            return lm_loss_chunked(params, cfg, x, batch["labels"],
                                   batch.get("mask"), cfg.loss_chunk)
    logits, _ = model_apply(params, cfg, batch, mode="train", shd=shd)
    with (shd or NO_SHARD).scope():
        return lm_loss(logits, batch["labels"], batch.get("mask"))


def _whole_vocab(x: torch.Tensor) -> torch.Tensor:
    """(B, V) logits with the vocab whole on every rank (a DTensor's vocab
    shards gathered; a plain tensor as it is), so the argmax is local."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    want = [Replicate() if isinstance(p, Partial) or p == Shard(x.dim() - 1)
            else p for p in x.placements]
    return x.redistribute(x.device_mesh, want) if want != list(
        x.placements) else x


def make_prefill(cfg: ArchConfig, shd: Optional[ShardCtx] = None):
    """prefill(params, batch, cache) -> (next_token_logits, cache)."""

    def prefill(params, batch, cache):
        logits, new_cache = model_apply(params, cfg, batch, mode="prefill",
                                        shd=shd, cache=cache, cache_len=0)
        return logits[:, -1], new_cache

    return prefill


def make_decode_step(cfg: ArchConfig, shd: Optional[ShardCtx] = None):
    """decode(params, cache, cache_len, last_tokens, extra=None) ->
    (next_tokens, logits, cache); ``cache_len`` a Python int, ``extra``
    more batch entries, the greedy tokens int32 (argmax: the first index
    on ties)."""

    def decode(params, cache, cache_len, last_tokens, extra=None):
        batch = {"tokens": last_tokens}
        if extra:
            batch.update(extra)
        logits, new_cache = model_apply(params, cfg, batch, mode="decode",
                                        shd=shd, cache=cache,
                                        cache_len=cache_len)
        last = _whole_vocab(logits[:, -1])
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt, last, new_cache

    return decode
