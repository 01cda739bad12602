"""Model operations a token, from a configuration file's published keys.

Conventions: a matrix product of (m, k) by (k, n) is 2mnk operations; a
token's forward is 2 operations a weight it multiplies (the embedding
lookup multiplies none, a head does) plus its mixer's sequence work; a
training step is 3 forwards (backward twice the forward), recompute not
counted; a MoE layer counts the experts a token is routed to (top-k) and
the shared ones, not the other experts.
"""
from __future__ import annotations

from . import checks


def forward_per_token(c: dict, seq: int) -> float:
    """A token's forward operations at context ``seq``: the
    configuration's family counts them (``reference/<family>.py``'s
    ``forward_ops``), so a later family is a new file."""
    return checks.reference_module(c).forward_ops(c, seq)


def train_per_token(c: dict, seq: int) -> float:
    return 3 * forward_per_token(c, seq)
