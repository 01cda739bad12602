"""Core — parallel combining + the batched priority queue, on PyTorch."""
from .combining import ParallelCombiner, PublicationRecord, Request, Status
from .flat_combining import flat_combining
from .locks import LockDS, RWLockDS
from .seq_pq import SequentialHeap
from .skiplist_pq import SkipListPQ
from .batched_pq import (
    BatchedPriorityQueue,
    HeapState,
    apply_batch,
    apply_batch_reference,
    check_heap_property,
    heap_init,
)
from .sharded_pq import (
    ShardedBatchedPQ,
    ShardedHeapState,
    sharded_apply_batch,
)
from .pc_pq import (
    AsyncRoundsPQ,
    fc_priority_queue,
    pc_adaptive_priority_queue,
    pc_priority_queue,
    pc_sharded_priority_queue,
)
from . import substrate

__all__ = [
    "ParallelCombiner", "PublicationRecord", "Request", "Status",
    "flat_combining", "LockDS", "RWLockDS",
    "SequentialHeap", "SkipListPQ",
    "BatchedPriorityQueue", "HeapState", "apply_batch",
    "apply_batch_reference", "check_heap_property", "heap_init",
    "ShardedBatchedPQ", "ShardedHeapState", "sharded_apply_batch",
    "AsyncRoundsPQ", "fc_priority_queue", "pc_adaptive_priority_queue",
    "pc_priority_queue", "pc_sharded_priority_queue",
    "substrate",
]
