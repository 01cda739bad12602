"""Phase 4 of the batched heap pass: the collective insert kernel."""
from .ops import (chunk_len, insert_chunk, insert_chunk_plain, phase4,
                  phase4_plain, phase4_sharded)

__all__ = ["chunk_len", "insert_chunk", "insert_chunk_plain", "phase4",
           "phase4_plain", "phase4_sharded"]
