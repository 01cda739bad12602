"""Share (%) of the card's bf16 peak that the useful tokens' model
operations (prompt and generated tokens of the requests answered in the
window, no padding) take over the window."""
from portbench import flops, roofline


def read(run):
    c = run["counters"]
    if not c.get("requests"):
        return None
    seq = c["tokens"] / c["requests"]
    ops = c["tokens"] * flops.forward_per_token(run["config"], seq)
    return 100.0 * ops / run["window_s"] / roofline.BF16_OPS_PER_S
