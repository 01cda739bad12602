"""Requests a combined executor call in the window (``PCScheduler``'s
batches, as the benchmark's wrapper saw them)."""


def read(run):
    return run["counters"].get("sched_mean_batch")
