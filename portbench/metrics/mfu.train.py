"""Share (%) of the card's bf16 peak that the window's training steps'
model operations take (3 forwards a token, recompute not counted)."""
from portbench import flops, roofline


def read(run):
    c = run["counters"]
    if not c.get("steps"):
        return None
    ops = c["tokens"] * flops.train_per_token(run["config"],
                                              run["traffic"]["seq"])
    return 100.0 * ops / run["window_s"] / roofline.BF16_OPS_PER_S
