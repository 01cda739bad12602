"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and the run's seed.

Two kinds of mix:

* ``serve_closed``: a pool of requests that client sessions take in
  turn.  Every seed gets the same multiset of prompt and output lengths
  (the lengths sit at evenly spaced quantiles of the mix's
  distributions); the seed only orders them and draws the prompt
  tokens, so two seeds do the same work in another order.  The order is
  stratified: every ``block`` consecutive requests hold one length from
  each of ``block`` bands of neighbouring quantiles, so any stretch of
  whole blocks, as a window sees, holds the same mix of lengths.
* ``train``: packed documents, a copy of the port's synthetic pipeline
  (Zipf unigrams over [2, vocab), geometric document lengths, a BOS
  between documents, next-token labels, pad and BOS labels masked).  Row
  ``r`` of step ``t`` is a pure function of (seed, t, r), so every row of
  every step differs.
"""
from __future__ import annotations

import queue
import threading
from statistics import NormalDist
from typing import Dict, Iterator, List

import numpy as np

BOS, PAD = 1, 0


def seed_words(seed: int, *more: int) -> np.random.SeedSequence:
    """A SeedSequence from any whole-number seed and stream ids."""
    return np.random.SeedSequence([seed % (1 << 64), *more])


def _lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of the distribution."""
    q = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
        vals = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        vals = spec["min"] + q * (spec["max"] + 1 - spec["min"])
        vals = np.floor(vals)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def _zipf_tokens(rng: np.random.Generator, n: int, a: float,
                 vocab: int) -> np.ndarray:
    toks = rng.zipf(a, size=n)
    return ((toks - 1) % (vocab - 2) + 2).astype(np.int32)


def _stratified(rng: np.random.Generator, values: np.ndarray,
                block: int) -> np.ndarray:
    """``values`` in an order whose every ``block`` consecutive entries
    hold one value of each of ``block`` bands of the sorted values."""
    n = len(values)
    if n % block:
        raise ValueError(f"a pool of {n} is not whole blocks of {block}")
    bands = np.sort(values).reshape(block, n // block)
    for band in bands:
        rng.shuffle(band)
    blocks = bands.T.copy()                  # block j: one of each band
    for b in blocks:
        rng.shuffle(b)
    return blocks.reshape(-1)


def serve_pool(mix: dict, vocab: int, seed: int) -> List[dict]:
    """The mix's request pool, in the seed's order: ``[{"prompt": (L,)
    int32, "n_tokens": int}]``."""
    n, block = int(mix["pool"]), int(mix["block"])
    rng = np.random.default_rng(seed_words(seed, 1))
    plen = _stratified(rng, _lengths(mix["prompt_len"], n), block)
    olen = _stratified(rng, _lengths(mix["output_len"], n), block)
    return [{"prompt": _zipf_tokens(rng, int(p), mix["zipf_a"], vocab),
             "n_tokens": int(o)} for p, o in zip(plen, olen)]


def _doc_stream(rng: np.random.Generator, vocab: int, seq: int,
                zipf_a: float, mean_doc: int) -> np.ndarray:
    out = np.empty(seq + max(4 * mean_doc, seq) + 8, np.int32)
    pos = 0
    while pos < seq:
        dlen = max(2, min(int(rng.geometric(1.0 / mean_doc)), seq))
        out[pos] = BOS
        out[pos + 1: pos + dlen] = _zipf_tokens(rng, dlen - 1, zipf_a,
                                                vocab)
        pos += dlen
    return out[:seq]


def train_batch(mix: dict, vocab: int, seed: int,
                step: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s host batch: tokens, labels and mask."""
    B, S = int(mix["batch"]), int(mix["seq"])
    tokens = np.empty((B, S), np.int32)
    for r in range(B):
        rng = np.random.default_rng(seed_words(seed, 2, step, r))
        tokens[r] = _doc_stream(rng, vocab, S, mix["zipf_a"],
                                int(mix["mean_doc_len"]))
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), PAD, np.int32)],
                            axis=1)
    mask = ((labels != PAD) & (labels != BOS)).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "mask": mask}


class Prefetch:
    """Host batches made on one thread, ``depth`` ahead of the steps."""

    def __init__(self, mix: dict, vocab: int, seed: int, start: int = 0,
                 depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._args = (mix, vocab, seed)
        self._th = threading.Thread(target=self._run, args=(start,),
                                    name="portbench-feed", daemon=True)
        self._th.start()

    def _run(self, step: int) -> None:
        while not self._stop.is_set():
            hb = train_batch(*self._args, step)
            while not self._stop.is_set():
                try:
                    self._q.put(hb, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self._q.get()

    def close(self) -> None:
        self._stop.set()
        self._th.join(timeout=30)
