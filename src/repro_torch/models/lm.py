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
from .transformer import model_apply


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) f32, labels (B,S) ints."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
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
    ll = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
    return ((lse - ll) * m_c).sum(), m_c.sum()


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


def loss_fn(params, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.loss_chunk:
        x, _ = model_apply(params, cfg, batch, mode="train_hidden")
        return lm_loss_chunked(params, cfg, x, batch["labels"],
                               batch.get("mask"), cfg.loss_chunk)
    logits, _ = model_apply(params, cfg, batch, mode="train")
    return lm_loss(logits, batch["labels"], batch.get("mask"))


def make_prefill(cfg: ArchConfig):
    """prefill(params, batch, cache) -> (next_token_logits, cache)."""

    def prefill(params, batch, cache):
        logits, new_cache = model_apply(params, cfg, batch, mode="prefill",
                                        cache=cache, cache_len=0)
        return logits[:, -1], new_cache

    return prefill


def make_decode_step(cfg: ArchConfig):
    """decode(params, cache, cache_len, last_tokens, extra=None) ->
    (next_tokens, logits, cache); ``cache_len`` a Python int, ``extra``
    more batch entries, the greedy tokens int32 (argmax: the first index
    on ties)."""

    def decode(params, cache, cache_len, last_tokens, extra=None):
        batch = {"tokens": last_tokens}
        if extra:
            batch.update(extra)
        logits, new_cache = model_apply(params, cfg, batch, mode="decode",
                                        cache=cache, cache_len=cache_len)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, logits[:, -1], new_cache

    return decode
