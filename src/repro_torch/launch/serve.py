"""Serving: the slot-based batched decode executor.

The port of ``DecodeExecutor`` from the reference's ``launch/serve.py``
(the device side of its scheduler).  ``run_serving``, the structure
executor and the CLI are not ported yet (ROADMAP A5, A10).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core.batched_pq import resolve_device
from ..models import lm, transformer


class DecodeExecutor:
    """Slot-based batched decode executor.

    Holds a fixed (max_batch, ...) cache; each call takes ≤ max_batch
    (prompt, n_tokens) requests, left-pads the prompts with token 0 (no
    padding mask, positions from 0, as the reference: a recurrent state
    absorbs the padding tokens), prefills them into the slots and greedily
    decodes n_tokens.  The weights are drawn from ``seed`` (``model_init``)
    unless ``params`` are given.  The cache is K/V for attention layers
    (a ring of window + 1 slots for local ones), the recurrent state for
    RWKV-6 and RG-LRU layers (O(1) in the context): K/V, the RG-LRU conv
    history and the RWKV token-shift inputs in ``cache_dtype`` (bf16, as
    the reference's), the recurrent states in f32.  The generated
    tokens stay on the device until one fetch at the end of the call.
    With ``keep_logits`` the call keeps each step's next-token logits in
    ``step_logits`` (prefill first, then each decode step's).
    """

    def __init__(self, cfg, *, max_batch: int = 8, max_len: int = 128,
                 seed: int = 0, device=None, params=None,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 keep_logits: bool = False):
        self.cfg = cfg.with_(decode_cache_len=max_len)
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = (params if params is not None else
                       transformer.model_init(seed, self.cfg,
                                              device=self.device))
        self.cache_dtype = cache_dtype
        self._prefill = lm.make_prefill(self.cfg)
        self._decode = lm.make_decode_step(self.cfg)
        self.device_steps = 0
        self.keep_logits = keep_logits
        self.step_logits: List[torch.Tensor] = []

    def __call__(self, reqs: List[Dict[str, Any]]) -> List[np.ndarray]:
        """reqs: [{'prompt': (S,) int32, 'n_tokens': int}] — one combined
        batch; returns per-request generated token arrays."""
        if len(reqs) > self.max_batch:
            raise ValueError(f"{len(reqs)} requests for {self.max_batch} "
                             "slots")
        S = max(len(r["prompt"]) for r in reqs)
        n_gen = max(int(r["n_tokens"]) for r in reqs)
        toks = np.zeros((self.max_batch, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r["prompt"]):] = r["prompt"]   # left-pad
        cache = transformer.init_cache(self.cfg, self.max_batch,
                                       self.max_len, dtype=self.cache_dtype,
                                       device=self.device)
        tokens = torch.from_numpy(toks).to(self.device)
        logits, cache = self._prefill(self.params, {"tokens": tokens}, cache)
        self.device_steps += 1
        self.step_logits = [logits] if self.keep_logits else []
        last = torch.argmax(logits, -1).to(torch.int32)[:, None]
        pos = S
        gen = []
        for _ in range(n_gen):
            gen.append(last[:, 0])
            nxt, step, cache = self._decode(self.params, cache, pos, last)
            self.device_steps += 1
            if self.keep_logits:
                self.step_logits.append(step)
            last = nxt[:, None]
            pos += 1
        out = (torch.stack(gen, 1).cpu().numpy() if gen else
               np.zeros((self.max_batch, 0), np.int32))
        return [out[i, : int(r["n_tokens"])] for i, r in enumerate(reqs)]
