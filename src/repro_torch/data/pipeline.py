"""Deterministic, host-sharded synthetic token pipeline.

A copy of the reference's ``data/pipeline.py``: numpy only, no framework,
so its batches equal the reference's bit for bit.

Design constraints (from DESIGN.md §6 — elastic scaling + fault tolerance):

* **Stateless indexing** — batch ``t`` is a pure function of
  ``(seed, step t, global shape)``.  Restart/resume needs no data-iterator
  checkpoint: the train loop stores only the step counter.  Elastic
  re-sharding is trivial for the same reason: host ``h`` of ``H`` computes
  rows ``[h·B/H, (h+1)·B/H)`` of the *global* batch, so changing ``H``
  never changes the data stream.
* **Mixture + packing realism** — documents are sampled from a Zipfian
  unigram model over the vocab with per-stream document lengths, packed
  back-to-back into fixed-length rows (the standard LM packing), with an
  optional BOS separator.  Labels are next-token shifted; pad/document
  boundaries are masked.
* **Pure numpy on the host** (no device work in the input path); the train
  loop overlaps host batch synthesis with device compute via a one-deep
  prefetch thread (``TokenPipeline.prefetch``).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    mean_doc_len: int = 512
    bos_id: int = 1
    pad_id: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _doc_stream(rng: np.random.Generator, cfg: DataConfig, n_tokens: int):
    """Sample documents until >= n_tokens tokens are produced.

    The buffer holds the last document whole: it may start at
    ``n_tokens - 1`` and run ``seq_len`` tokens.  (The reference sizes it
    ``n_tokens + 4·mean_doc_len + 8`` and fails once a document runs past
    that, which ``seq_len > 4·mean_doc_len + 8`` allows: ROADMAP C5.  The
    draws and the tokens returned are the same.)"""
    out = np.empty(n_tokens + max(cfg.mean_doc_len * 4, cfg.seq_len) + 8,
                   np.int32)
    pos = 0
    while pos < n_tokens:
        dlen = int(rng.geometric(1.0 / cfg.mean_doc_len))
        dlen = max(2, min(dlen, cfg.seq_len))
        # Zipf over [2, vocab): ids 0/1 reserved for pad/bos
        toks = rng.zipf(cfg.zipf_a, size=dlen - 1)
        toks = (toks - 1) % (cfg.vocab - 2) + 2
        out[pos] = cfg.bos_id
        out[pos + 1: pos + dlen] = toks
        pos += dlen
    return out[:n_tokens]


class TokenPipeline:
    """Indexable synthetic dataset: ``pipeline[t]`` is global batch ``t``."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.cfg = cfg
        self.rows_per_host = cfg.global_batch // cfg.n_hosts

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The full (global_batch, seq) batch — used by tests/single host."""
        return self._rows(step, 0, self.cfg.global_batch)

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        """This host's row shard of the global batch."""
        r0 = self.cfg.host_id * self.rows_per_host
        return self._rows(step, r0, self.rows_per_host)

    def _rows(self, step: int, row0: int, n_rows: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        S = cfg.seq_len
        tokens = np.empty((n_rows, S), np.int32)
        for i in range(n_rows):
            row = row0 + i
            # independent, reproducible stream per (seed, step, global row)
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, row]))
            tokens[i] = _doc_stream(rng, cfg, S)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((n_rows, 1), cfg.pad_id, np.int32)],
            axis=1)
        mask = (labels != cfg.pad_id) & (labels != cfg.bos_id)
        return {"tokens": tokens, "labels": labels,
                "mask": mask.astype(np.float32)}

    def __getitem__(self, step: int) -> Dict[str, np.ndarray]:
        return self.host_batch(step)

    def prefetch(self, start_step: int, depth: int = 2
                 ) -> Iterator[Dict[str, np.ndarray]]:
        """Background-thread prefetch iterator from ``start_step``."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def producer():
            t = start_step
            while not stop.is_set():
                try:
                    q.put(self.host_batch(t), timeout=0.5)
                    t += 1
                except queue.Full:
                    continue

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_pipeline(vocab: int, seq_len: int, global_batch: int, *,
                  seed: int = 0, n_hosts: int = 1, host_id: int = 0,
                  **kw) -> TokenPipeline:
    return TokenPipeline(DataConfig(
        vocab=vocab, seq_len=seq_len, global_batch=global_batch, seed=seed,
        n_hosts=n_hosts, host_id=host_id, **kw))
