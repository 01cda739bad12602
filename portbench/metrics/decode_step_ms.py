"""Host ms a decode step, each step closed by a synchronize (the traced
run's wrapper around the executor's decode step; the profiled call's
steps left out)."""


def read(run):
    c = run["counters"]
    n = c.get("decode_steps", 0)
    return 1e3 * c["decode_s"] / n if n else None
