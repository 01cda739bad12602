#!/usr/bin/env python3
"""Time ``attn_remat``'s per-pair recompute by three mechanisms beside the
flag off, on a Qwen2-0.5B train step.

    PYTHONPATH=src python3 tools/attn_remat_ablation.py [--seqs 4096 8192]
        [--rounds 2] [--layers 24] [--device cuda]

Variants, each swapped in for ``models/attention.py``'s ``checkpoint``
(the call each chunk pair runs under when ``attn_remat`` is set):

- ``off``: ``attn_remat`` off (every pair's scores kept for the backward);
- ``checkpoint``: as built, ``torch.utils.checkpoint(use_reentrant=False)``
  with its defaults (the RNG state saved and restored around each pair);
- ``checkpoint_no_rng``: the same with ``preserve_rng_state=False`` (a
  pair draws no random numbers, so the result is the same);
- ``function``: an ``autograd.Function`` that runs the pair without
  autograd, saves its inputs, and in its backward runs it again under
  autograd and calls ``torch.autograd.grad`` on it.

For each variant: the loss and every gradient of one step at the first S
against ``off``, bit for bit; then, in ``--rounds`` rounds that visit the
variants in turn, one warm step at the first S and one timed train step
(the loss fetched) at each S with the peak memory counted afresh.  Prints
one line a variant with the median ms and the peak a S.  Period ``remat``
is on throughout, batch 1, weights from seed 0.  On the CPU pass small
``--seqs`` and ``--layers``.
"""
from __future__ import annotations

import argparse
import functools
import statistics
import time

import torch
from torch.utils import checkpoint as ck

from repro_torch import configs
from repro_torch.data import make_pipeline
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.launch.train import device_batch
from repro_torch.models import attention, transformer
from repro_torch.optim import adamw_init
from repro_torch.optim.tree import leaves


class _PairRecompute(torch.autograd.Function):
    """The pair without autograd in the forward; recomputed in the
    backward."""

    @staticmethod
    def forward(ctx, pair, *args):
        ctx.pair = pair
        ctx.save_for_backward(*args)
        with torch.no_grad():
            return pair(*args)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[1:]
        ins = [a.detach().requires_grad_(n)
               for a, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = ctx.pair(*ins)
        used = [(o, g) for o, g in zip(outs, grads)
                if g is not None and o.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in used], [x for x, n in zip(ins, need) if n],
            [g for _, g in used], allow_unused=True))
        return (None,) + tuple(next(got) if n else None for n in need)


def _function(pair, *args, use_reentrant=None):
    return _PairRecompute.apply(pair, *args)


VARIANTS = {
    "off": None,
    "checkpoint": ck.checkpoint,
    "checkpoint_no_rng": functools.partial(ck.checkpoint,
                                           preserve_rng_state=False),
    "function": _function,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seqs", type=int, nargs="+", default=[4096, 8192])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    cfg0 = configs.get("qwen2_0_5b").with_(remat=True)
    if args.layers:
        cfg0 = cfg0.with_(n_layers=args.layers)
    params = transformer.model_init(0, cfg0, device=dev)
    opt = adamw_init(params)
    batches = {S: device_batch(cfg0, make_pipeline(cfg0.vocab, S, 1, seed=0)
                               .global_batch(0), 0, 0, dev)
               for S in args.seqs}
    if cuda:
        print(torch.cuda.get_device_name(0))

    def with_variant(name):
        fn = VARIANTS[name]
        attention.checkpoint = fn or ck.checkpoint
        return cfg0.with_(attn_remat=fn is not None)

    S0 = args.seqs[0]
    base = None
    equal = {}
    for name in VARIANTS:
        loss, grads = loss_and_grads(params, with_variant(name), batches[S0])
        got = [loss] + leaves(grads)
        base = base or got
        equal[name] = all(torch.equal(a, b) for a, b in zip(base, got))
        del grads, got
    times = {n: {S: [] for S in args.seqs} for n in VARIANTS}
    peaks = {n: {} for n in VARIANTS}
    for _ in range(args.rounds):
        for name in VARIANTS:
            step = make_train_step(with_variant(name), lr=1e-3)
            float(step(params, opt, batches[S0])[2]["loss"])
            for S in args.seqs:
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                float(step(params, opt, batches[S])[2]["loss"])
                times[name][S].append((time.perf_counter() - t0) * 1e3)
                if cuda:
                    peaks[name][S] = torch.cuda.max_memory_allocated()
    attention.checkpoint = ck.checkpoint
    for name in VARIANTS:
        print(f"{name}: loss and gradients at S {S0} bit-equal to off: "
              f"{equal[name]}; " + "; ".join(
                  f"S {S} step {statistics.median(times[name][S]):.3f} ms "
                  f"(rounds {', '.join(f'{t:.3f}' for t in times[name][S])})"
                  f", max_memory_allocated {peaks[name].get(S)}"
                  for S in args.seqs))


if __name__ == "__main__":
    main()
