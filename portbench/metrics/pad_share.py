"""Share (%) of the prefill's max_batch x S token slots that are padding
(left padding and empty rows), over the window's executor calls."""


def read(run):
    c = run["counters"]
    return 100.0 * c["pad_slots"] / c["slots"] if c.get("slots") else None
