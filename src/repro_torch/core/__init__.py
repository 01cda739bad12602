"""Core — parallel combining, the batched priority queue, the dynamic
graph, the union-find, the ordered map and the counting sketch, on
PyTorch."""
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
    pc_megapass_priority_queue,
    pc_priority_queue,
    pc_sharded_priority_queue,
)
from .dynamic_graph import DynamicGraph
from .device_graph import AsyncUpdateResult, DeviceGraph, GraphState
from .read_opt import (
    AdaptiveReadWrite,
    BatchedReadOptimized,
    MegapassCombiner,
    adaptive_read_engine,
    batched_read_optimized,
    pc_adaptive_graph,
    read_optimized_combining,
)
from .seq_union_find import SequentialUnionFind
from .batched_union_find import BatchedUnionFind, UFState
from .pc_union_find import (
    fc_union_find,
    pc_adaptive_union_find,
    pc_batched_union_find,
    pc_union_find,
)
from .seq_map import SequentialSortedMap
from .batched_map import BatchedMap, MapState, ShardedMap
from .pc_map import (fc_map, pc_adaptive_map, pc_map, pc_megapass_map,
                     pc_sharded_map)
from .seq_sketch import SequentialSketch
from .batched_sketch import ShardedSketch, SketchState
from .pc_sketch import (fc_sketch, pc_adaptive_sketch, pc_sharded_sketch,
                        pc_sketch)
from . import substrate

__all__ = [
    "ParallelCombiner", "PublicationRecord", "Request", "Status",
    "flat_combining", "LockDS", "RWLockDS",
    "SequentialHeap", "SkipListPQ",
    "BatchedPriorityQueue", "HeapState", "apply_batch",
    "apply_batch_reference", "check_heap_property", "heap_init",
    "ShardedBatchedPQ", "ShardedHeapState", "sharded_apply_batch",
    "AsyncRoundsPQ", "fc_priority_queue", "pc_adaptive_priority_queue",
    "pc_megapass_priority_queue", "pc_priority_queue",
    "pc_sharded_priority_queue",
    "DynamicGraph", "AsyncUpdateResult", "DeviceGraph", "GraphState",
    "AdaptiveReadWrite", "BatchedReadOptimized", "MegapassCombiner",
    "adaptive_read_engine", "batched_read_optimized", "pc_adaptive_graph",
    "read_optimized_combining",
    "SequentialUnionFind", "BatchedUnionFind", "UFState",
    "fc_union_find", "pc_adaptive_union_find", "pc_batched_union_find",
    "pc_union_find",
    "SequentialSortedMap", "BatchedMap", "MapState", "ShardedMap",
    "fc_map", "pc_adaptive_map", "pc_map", "pc_megapass_map",
    "pc_sharded_map",
    "SequentialSketch", "ShardedSketch", "SketchState",
    "fc_sketch", "pc_adaptive_sketch", "pc_sharded_sketch", "pc_sketch",
    "substrate",
]
