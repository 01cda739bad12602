"""Phase 1 of the batched heap pass: the frontier search kernel."""
from .ops import k_smallest, k_smallest_plain, k_smallest_sharded

__all__ = ["k_smallest", "k_smallest_plain", "k_smallest_sharded"]
