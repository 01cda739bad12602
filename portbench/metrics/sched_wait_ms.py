"""Median ms from a request's submit to the start of the executor call
that serves it, over the requests answered in the window."""
import statistics


def read(run):
    waits = run["samples"].get("sched_wait_s")
    return statistics.median(waits) * 1e3 if waits else None
