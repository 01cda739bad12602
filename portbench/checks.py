"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference (``reference/``) on the same inputs.

Serving: a sample of the finished requests, drawn from the seed, with
the longest in it.  The reference runs once over each request's padded
prompt and its served tokens (teacher forcing), and each served token is
read by how far its reference logit lies below the reference's best at
that position (``gap``: 0 where the greedy token is the reference's own
choice).  The number compared is the widest gap.

Training: the set-up's first steps go through the window's own step and
feed; the reference follows them from the same weights and batches.
Compared: each step's loss (absolute gap), each leaf's norm of the first
gradient as the optimizer got it (clipped), and each leaf's norm of its
change over the steps; a leaf's gap is |program - reference| over the
larger of the reference's norm of that leaf and of the median leaf.  The
change skips leaves whose reference gradient is under a thousandth of
the median leaf's (they move by round-off alone).

The control (``control.py``) is the reference in a lower precision put
in the program's place: its numbers are the ones judged, under the same
limits, and it has to come out not correct.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, List

import numpy as np

from . import traffic


def reference_module(config: dict):
    return importlib.import_module(f"portbench.reference.{config['family']}")


def serve_sample(served: List[int], done: Dict[int, dict], pool, padded,
                 seed: int, n: int) -> List[dict]:
    """``n`` served requests drawn from the seed, the one with the most
    positions (padded prompt plus served tokens) first among them."""
    if not served:
        return []
    ranked = sorted(served, key=lambda r: (-(padded[r]
                                             + len(done[r]["out"])), r))
    rng = np.random.default_rng(traffic.seed_words(seed, 3))
    rest = ranked[1:]
    pick = [ranked[0]] + [rest[i] for i in
                          rng.choice(len(rest), size=min(n - 1, len(rest)),
                                     replace=False)]
    out = []
    for r in pick:
        prompt = pool[r % len(pool)]["prompt"]
        out.append({"rid": r, "prompt": prompt, "padded": padded[r],
                    "served": done[r]["out"].astype(np.int64)})
    return out


def serve_gaps(ref, W, config: dict, sample: List[dict], device,
               control=None) -> Dict[str, Any]:
    """The widest gap of the served tokens.  With ``control`` (a lower
    precision) the numbers are the control's, in the program's place: at
    the same positions, the gap of the token it puts first; the
    program's own numbers come beside them as ``program_*``."""
    import torch

    from .reference.precision import F32

    rows = {"program": [], "control": []}
    with torch.no_grad():
        for s in sample:
            served = s["served"]
            n = len(served)
            if n == 0:
                continue
            pad = s["padded"] - len(s["prompt"])
            seq = np.concatenate([np.zeros(pad, np.int64),
                                  s["prompt"].astype(np.int64),
                                  served[:-1]])
            toks = torch.from_numpy(seq).to(device)
            pos = list(range(s["padded"] - 1, s["padded"] - 1 + n))
            lg = ref.logits_at(W, config, toks, pos, F32)
            best = lg.max(dim=-1).values
            at = torch.arange(n, device=device)
            picks = {"program": torch.from_numpy(served).to(device)}
            if control is not None:
                picks["control"] = ref.logits_at(W, config, toks, pos,
                                                 control).argmax(dim=-1)
            for who, pick in picks.items():
                rows[who].append((s, (best - lg[at, pick]).cpu()))
    out = _gaps(rows["program"])
    if control is None:
        return out
    return dict(_gaps(rows["control"]),
                **{f"program_{k}": v for k, v in out.items()})


def _gaps(rows) -> Dict[str, Any]:
    """The widest gap over ``(request, gaps)`` rows; where it lies:
    [token, of n served, padded length, prompt length]; and how many
    tokens are not the reference's best."""
    worst, where, n_tok, flips = 0.0, None, 0, 0
    for s, gap in rows:
        j = int(gap.argmax())
        if where is None or float(gap[j]) > worst:
            worst = max(worst, float(gap[j]))
            where = [j, len(gap), s["padded"], len(s["prompt"])]
        flips += int((gap > 0).sum())
        n_tok += len(gap)
    return {"gap_max": worst, "tokens_compared": n_tok, "gap_at": where,
            "tokens_off_best": flips}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def train_compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared for a training cell."""
    n = len(ref["losses"])
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"][:n],
                                              ref["losses"]))
    grad = leaf_gaps(prog["grad0"], ref["grad0"])
    gmed = float(np.median(list(ref["grad0"].values())))
    moving = {k for k, g in ref["grad0"].items() if g >= 1e-3 * gmed}
    change = leaf_gaps(prog["change"], ref["change"], moving)
    def top(gaps, p, r, k=4):
        names = sorted(gaps, key=gaps.get, reverse=True)[:k]
        return [[n, gaps[n], p[n], r[n]] for n in names]

    return {"loss_gap": loss_gap,
            "loss1_gap": abs(prog["losses"][0] - ref["losses"][0]),
            "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "grad_worst": top(grad, prog["grad0"], ref["grad0"]),
            "change_worst": top(change, prog["change"], ref["change"]),
            "grad_median": gmed,
            "leaves_left_out": len(ref["grad0"]) - len(moving)}
