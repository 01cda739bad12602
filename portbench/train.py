"""The ``train`` mix: the port's training step as ``launch/train.py``
runs it: ``steps.make_train_step`` on the benchmark's weights (drawn
from the seed, ``Context.weights``) and ``adamw_init``'s state, each
step's batch put on the device by ``train.device_batch``, one loss fetch
a step.

Set-up builds that one step object and drives it through the mix's
``check_steps`` first steps on the window's own call and feed; it reads
each step's loss, each leaf's norm of the first gradient from the
optimizer's first moment after step 1 (m = (1 - b1) x the clipped
gradient), and, after the last of them, each leaf's norm of its change
from the initial weights (drawn again from the seed).  The window then
runs whole steps until ``seconds`` have passed; it ends with the last
step's loss fetch.
"""
from __future__ import annotations

import time
from typing import List

from . import checks, traffic
from .reference.common import diff_norm, flatten, leaf_norm, train_steps
from .reference.precision import F32, strict_f32
from .devtrace import Tracer

B1 = 0.9          # the port's AdamW first-moment decay


def run(ctx) -> dict:
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batch
    from repro_torch.optim import adamw_init

    mix, conf = ctx.traffic, ctx.config
    arch = ctx.arch()
    dev = ctx.device
    params = ctx.weights()
    opt = adamw_init(params)
    step_fn = make_train_step(arch, None, lr=float(mix["lr"]))
    feed = traffic.Prefetch(mix, arch.vocab, ctx.seed)
    it = iter(feed)
    step = 0

    def one_step():
        nonlocal params, opt, step
        batch = device_batch(arch, next(it), step, ctx.seed, dev)
        params, opt, m = step_fn(params, opt, batch)
        step += 1
        return float(m["loss"].float().item())

    n_check = int(mix["check_steps"])
    prog = {"losses": []}
    try:
        for s in range(n_check):
            prog["losses"].append(one_step())
            if s == 0:
                prog["grad0"] = {n: leaf_norm(m) / (1.0 - B1)
                                 for n, m in flatten(opt.m)}
        with torch.no_grad():
            p0 = dict(flatten(ctx.weights()))
            prog["change"] = {n: diff_norm(p, p0[n])
                              for n, p in flatten(params)}
            del p0
        ctx.sync()

        tracer = Tracer() if ctx.trace else None
        n_trace = int(mix["trace_steps"])
        w0 = time.perf_counter()
        ctx.window_started(w0)
        times: List[float] = []
        while True:
            traced = tracer is not None and len(times) == 1
            if traced:
                tracer.start()
            t = time.perf_counter()
            for _ in range(n_trace if traced else 1):
                one_step()
            if traced:
                tracer.stop()
            times.append(time.perf_counter() - t)
            if time.perf_counter() - w0 >= ctx.seconds:
                break
        w1 = time.perf_counter()
        ctx.window_closed()
    finally:
        feed.close()
    n_steps = step - n_check
    window = w1 - w0
    toks = n_steps * int(mix["batch"]) * int(mix["seq"])
    res = {
        "attempted": n_steps,
        "failed": 0,
        "window_s": window,
        "end_to_end": {"train_tokens_per_s": toks / window},
        "counters": {"steps": n_steps, "tokens": toks,
                     "traced_steps": n_trace if ctx.trace else 0},
        "samples": {},
        "trace": tracer.result() if tracer else None,
        "launches": tracer.launches if tracer else {},
    }
    ctx.mark_peak()
    del params, opt, step_fn
    ctx.free()

    ref = checks.reference_module(conf)

    def follow(prec):
        W = ctx.reference_weights(requires_grad=True)
        batches = (
            {k: torch.from_numpy(v).to(dev)
             for k, v in traffic.train_batch(mix, arch.vocab, ctx.seed,
                                             s).items()}
            for s in range(n_check))
        with strict_f32():
            got = train_steps(W, lambda w, b: ref.loss(w, conf, b, prec),
                              batches, float(mix["lr"]), n_check)
        del W
        ctx.free()
        return got

    t = time.perf_counter()
    want = follow(F32)
    nums = checks.train_compare(prog, want)
    nums["losses"] = prog["losses"]
    if ctx.control is not None:
        # the control, the reference in a lower precision, stands in the
        # program's place; the program's numbers come beside it
        got = follow(ctx.control)
        nums = dict(checks.train_compare(got, want), losses=got["losses"],
                    **{f"program_{k}": v for k, v in nums.items()})
    nums["ref_losses"] = want["losses"]
    res["check"] = nums
    res["readings"] = {"check_s": time.perf_counter() - t}
    return res
