"""Kernel launches a training step in the traced steps (device events
that are not copies or sets)."""


def read(run):
    tr, n = run.get("trace"), run["counters"].get("traced_steps")
    if tr is None or not n:
        return None
    k = [e for e in tr.device if not e[0].startswith(("Memcpy", "Memset"))]
    return len(k) / n if k else None
