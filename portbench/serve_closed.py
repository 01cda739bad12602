"""The ``serve_closed`` mix: client sessions in a closed loop on the
port's ``PCScheduler`` over one ``DecodeExecutor``.

Each session blocks on ``PCScheduler.submit`` for its request (deadline:
its submit time) and sends the next when the answer comes.  The
scheduler hands each combined batch to the benchmark's wrapper around
the executor, which notes the batch (its requests, their wait, the
padding) and calls the executor.  Set-up warms the one executor shape
set the mix needs (a full batch at the longest prompt and the most
tokens) and runs the loop for ``warmup_calls`` calls; the window starts
at the end of that call and ends at the end of the first call that ends
``seconds`` later, so it holds whole calls only.  A request counts in
the window when the call that answered it ended inside it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from . import checks, stats, traffic
from .reference.precision import strict_f32
from .devtrace import Tracer


class _Wrapper:
    """The ``step_fn`` handed to the scheduler: notes each call, then
    runs the executor."""

    def __init__(self, ex, tracer=None, trace_call=-1):
        self.ex = ex
        self.tracer, self.trace_call = tracer, trace_call
        self.calls: List[dict] = []
        self.start: Dict[int, float] = {}
        self.padded: Dict[int, int] = {}
        self.call_of: Dict[int, int] = {}
        self.cond = threading.Condition()

    def __call__(self, reqs):
        t0 = time.perf_counter()
        n = len(self.calls)
        S = max(len(r["prompt"]) for r in reqs)
        for r in reqs:
            self.start[r["rid"]] = t0
            self.padded[r["rid"]] = S
            self.call_of[r["rid"]] = n
        traced = self.tracer is not None and n == self.trace_call
        if traced:
            self.traced_call = {"n": len(reqs), "S": S}
            self.tracer.start()
        out = self.ex(reqs)
        if traced and self.tracer.active:
            self.tracer.stop()
        t1 = time.perf_counter()
        with self.cond:
            self.calls.append({"t0": t0, "t1": t1, "n": len(reqs), "S": S,
                               "own": sum(len(r["prompt"]) for r in reqs)})
            self.cond.notify_all()
        return out

    def wait_calls(self, n: int, timeout: float) -> None:
        with self.cond:
            if not self.cond.wait_for(lambda: len(self.calls) >= n, timeout):
                raise RuntimeError(f"{len(self.calls)} executor calls of "
                                   f"{n} after {timeout} s")

    def wait_end_after(self, t: float, timeout: float) -> int:
        """Index of the first call that ends at or after ``t``."""
        def found():
            return next((i for i, c in enumerate(self.calls)
                         if c["t1"] >= t), None)
        with self.cond:
            if not self.cond.wait_for(lambda: found() is not None, timeout):
                raise RuntimeError(f"no executor call ended after the "
                                   f"window within {timeout} s")
            return found()


def run(ctx) -> dict:
    from repro_torch.launch.serve import DecodeExecutor
    from repro_torch.serving import PCScheduler

    mix, conf = ctx.traffic, ctx.config
    arch = ctx.arch()
    vocab = arch.vocab
    pool = traffic.serve_pool(mix, vocab, ctx.seed)
    max_batch = int(mix["max_batch"])
    p_max, o_max = mix["prompt_len"]["max"], mix["output_len"]["max"]
    ex = DecodeExecutor(arch, max_batch=max_batch, max_len=p_max + o_max + 1,
                        device=ctx.device, params=ctx.weights())
    # the one shape set the mix needs: a full batch at the longest prompt
    # and the most tokens
    longest = max(pool, key=lambda r: len(r["prompt"]))["prompt"]
    warm = [{"prompt": np.resize(longest, p_max).astype(np.int32),
             "n_tokens": o_max} for _ in range(max_batch)]
    ex(warm)
    ctx.sync()

    tracer = Tracer() if ctx.trace else None
    wu = int(mix["warmup_calls"])
    if tracer is not None:
        tracer.register()
    wrap = _Wrapper(ex, tracer, trace_call=wu)
    step_times: List[float] = []
    if ctx.trace:
        orig = ex._decode

        traced_steps = [0]

        def timed_decode(*a, **kw):
            t = time.perf_counter()
            out = orig(*a, **kw)
            ctx.sync()
            if not tracer.active:
                step_times.append(time.perf_counter() - t)
            else:
                # the trace keeps the prefill and the first decode steps:
                # a whole call's ~10^5 kernels overflow the profiler
                traced_steps[0] += 1
                if traced_steps[0] == int(mix["trace_decode_steps"]):
                    tracer.stop()
            return out

        ex._decode = timed_decode
    sk = mix["scheduler"]
    sch = PCScheduler(wrap, max_batch=max_batch, use_pq=sk["use_pq"],
                      tier=sk["tier"], pipeline=sk["pipeline"],
                      device=ctx.device)
    lock = threading.Lock()
    stop = threading.Event()
    next_rid = [0]
    done: Dict[int, dict] = {}
    errors: List[BaseException] = []
    t_base = time.perf_counter()

    def session():
        while not stop.is_set():
            with lock:
                rid = next_rid[0]
                next_rid[0] += 1
            req = pool[rid % len(pool)]
            t_sub = time.perf_counter()
            try:
                out = sch.submit({"prompt": req["prompt"],
                                  "n_tokens": req["n_tokens"], "rid": rid},
                                 deadline=t_sub - t_base)
            except BaseException as exc:      # counted as failed
                with lock:
                    errors.append(exc)
                    done[rid] = {"t_sub": t_sub, "t_done": None, "out": None}
                return
            t_done = time.perf_counter()
            with lock:
                done[rid] = {"t_sub": t_sub, "t_done": t_done,
                             "out": np.asarray(out)}

    threads = [threading.Thread(target=session, name=f"portbench-s{i}",
                                daemon=True)
               for i in range(int(mix["sessions"]))]
    for t in threads:
        t.start()
    try:
        wrap.wait_calls(wu, timeout=300)
        w0 = wrap.calls[wu - 1]["t1"]
        ctx.window_started(w0)
        last = wrap.wait_end_after(w0 + ctx.seconds, timeout=ctx.seconds
                                   + 300)
        w1 = wrap.calls[last]["t1"]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=600)
        sch.close()
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client session did not end")
    ctx.window_closed()

    window = w1 - w0
    in_win = [rid for rid, d in done.items()
              if d["out"] is not None and wu <= wrap.call_of.get(rid, -1)
              <= last]
    lat = [done[r]["t_done"] - done[r]["t_sub"] for r in in_win]
    toks = sum(len(pool[r % len(pool)]["prompt"]) + len(done[r]["out"])
               for r in in_win)
    served = [r for r, d in done.items() if d["out"] is not None]
    short = [r for r in served
             if len(done[r]["out"]) != pool[r % len(pool)]["n_tokens"]]
    attempted = sum(1 for r in done if wu <= wrap.call_of.get(r, wu) <= last)
    calls = wrap.calls[wu:last + 1]
    own = sum(c["own"] for c in calls)
    slots = sum(max_batch * c["S"] for c in calls)
    res = {
        "attempted": attempted,
        "failed": sum(1 for r in done if done[r]["out"] is None) + len(short),
        "window_s": window,
        "end_to_end": {
            "serve_tokens_per_s": toks / window,
            "serve_p95_ms": (stats.percentile(lat, 95) * 1e3 if lat
                             else None),
        },
        "counters": {
            "requests": len(in_win), "tokens": toks,
            "traced_call": getattr(wrap, "traced_call", None),
            "sched_mean_batch": float(np.mean([c["n"] for c in calls])),
            "pad_slots": slots - own, "slots": slots,
            "decode_steps": len(step_times),
            "decode_s": float(sum(step_times)),
        },
        "samples": {"sched_wait_s": [wrap.start[r] - done[r]["t_sub"]
                                     for r in in_win]},
        "trace": tracer.result() if tracer else None,
        "launches": tracer.launches if tracer else {},
        # printed beside the check: what the window's calls carried
        "readings": {"calls": len(calls),
                     "mean_batch": float(np.mean([c["n"] for c in calls])),
                     "mean_padded_len": float(np.mean([c["S"]
                                                       for c in calls]))},
    }
    # what the check reads once the program's state is freed
    sample = checks.serve_sample(served, done, pool, wrap.padded, ctx.seed,
                                 int(mix["check_sample"]))
    ctx.mark_peak()
    del ex, sch, wrap
    ctx.free()
    t = time.perf_counter()
    W = ctx.reference_weights()
    with strict_f32():
        nums = checks.serve_gaps(checks.reference_module(conf), W, conf,
                                 sample, ctx.device, ctx.control)
    nums["short_answers"] = len(short)
    res["check"] = nums
    res["readings"]["check_s"] = time.perf_counter() - t
    return res
