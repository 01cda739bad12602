"""The map's and the sketch's shard rebuild: the merge-compact kernel."""
from .ops import merge_compact, merge_compact_plain, merge_compact_sharded

__all__ = ["merge_compact", "merge_compact_plain", "merge_compact_sharded"]
