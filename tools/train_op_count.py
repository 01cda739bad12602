#!/usr/bin/env python3
"""Count the operations one train step dispatches, with ``attn_remat`` off
and on, on the CPU.

    PYTHONPATH=src python3 tools/train_op_count.py [--arch qwen2_0_5b]
        [--layers 1 2] [--batch 2] [--seq 2048]

For each depth of ``--layers`` the config is cut to that many layers at
full width (period ``remat`` on, the config's other settings as they are),
and one ``loss_and_grads`` of the pipeline's first batch runs under a
``TorchDispatchMode`` that counts every aten call except views, aliases
and empty allocations.  On the card each such call is about one kernel
launch, so the difference between two depths is one layer's count, and
the difference between the flag off and on is what the pairs' recompute
adds (the Qwen2-0.5B train step is launch-bound, ROADMAP D20).  Prints one
line a depth and flag, then one layer's counts and the depth of the full
config scaled from them.  Keep the depths small: the model runs at full
width on the host.
"""
from __future__ import annotations

import argparse

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.data import make_pipeline
from repro_torch.launch.steps import loss_and_grads
from repro_torch.launch.train import device_batch
from repro_torch.models import transformer

NOT_LAUNCHES = frozenset((
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
    "transpose", "t", "slice", "select", "expand", "unsqueeze", "squeeze",
    "detach", "alias", "as_strided", "split", "split_with_sizes", "unbind",
    "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty_strided"))


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in NOT_LAUNCHES:
            self.n += 1
        return func(*args, **(kwargs or {}))


def count(arch: str, n_layers: int, batch: int, seq: int) -> dict:
    cfg = configs.get(arch).with_(n_layers=n_layers, remat=True)
    params = transformer.model_init(0, cfg, device="cpu")
    dev = torch.device("cpu")
    tb = device_batch(cfg, make_pipeline(cfg.vocab, seq, batch, seed=0)
                      .global_batch(0), 0, 0, dev)
    out = {}
    for flag in (False, True):
        mode = OpCount()
        with mode:
            loss_and_grads(params, cfg.with_(attn_remat=flag), tb)
        out[flag] = mode.n
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--layers", type=int, nargs=2, default=(1, 2))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    lo, hi = args.layers
    got = {L: count(args.arch, L, args.batch, args.seq) for L in (lo, hi)}
    for L, c in got.items():
        print(f"{args.arch} {L} layers, {args.batch} x {args.seq}: "
              f"attn_remat off {c[False]} ops, on {c[True]} ops")
    full = configs.get(args.arch).n_layers
    for flag in (False, True):
        layer = (got[hi][flag] - got[lo][flag]) / (hi - lo)
        rest = got[lo][flag] - lo * layer
        print(f"attn_remat {'on' if flag else 'off'}: {layer:.1f} ops a "
              f"layer, {rest:.1f} outside the layers; {full} layers "
              f"{rest + full * layer:.0f} ops a step")


if __name__ == "__main__":
    main()
