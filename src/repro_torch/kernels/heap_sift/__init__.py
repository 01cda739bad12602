"""Phase 3 of the batched heap pass: the sift-down wavefront kernel."""
from .ops import sift_wavefront, sift_wavefront_plain, sift_wavefront_sharded

__all__ = ["sift_wavefront", "sift_wavefront_plain", "sift_wavefront_sharded"]
