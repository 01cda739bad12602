"""Parallel-combining counting/top-k sketch (§3.3 over the batched
sketch).

Increments commute, so the sketch is the cheapest possible combining
client: the combiner nets the whole update list into ``add``
passes (``update_batch_async`` — "created a counter?" masks stay on
device and ride the read fetch) and answers the read list (``count`` /
``total`` / ``distinct`` / ``topk``) with ONE vectorized ``read_batch``
pass.  ``fc_sketch`` is the host flat-combining baseline over the
sequential dict sketch.  The port of ``repro.core.pc_sketch``: every
device engine takes ``device=None``, which means the card (``"cuda"``).
"""
from __future__ import annotations

from typing import Optional

from .batched_sketch import ShardedSketch
from .combining import ParallelCombiner, TierRouter
from .flat_combining import flat_combining
from .read_opt import adaptive_read_engine, batched_read_optimized
from .seq_sketch import SequentialSketch


def pc_sketch(s: ShardedSketch, **kw) -> ParallelCombiner:
    """§3.3 batched-read combining over a device-resident sketch."""
    return batched_read_optimized(s, **kw)


def pc_sharded_sketch(capacity: int, c_max: int, n_shards: int = 2,
                      topk_max: int = 8, items=None,
                      use_pallas: bool = False, donate: bool = True,
                      fault_plan=None, guard=None, device=None,
                      **kw) -> ParallelCombiner:
    """Parallel combining over the K-sharded batched sketch (DESIGN.md
    §16): hash-routed shards, in-place passes, sync-free occupancy
    guard; ``fault_plan``/``guard`` thread the §15 transactional layer
    through structure and engine alike."""
    if fault_plan is not None:
        kw.setdefault("fault_plan", fault_plan)
    return pc_sketch(ShardedSketch(capacity, c_max=c_max,
                                   n_shards=n_shards, topk_max=topk_max,
                                   items=items, use_pallas=use_pallas,
                                   donate=donate, fault_plan=fault_plan,
                                   guard=guard, device=device), **kw)


def pc_adaptive_sketch(capacity: int, c_max: int, n_shards: int = 2,
                       topk_max: int = 8, items=None,
                       use_pallas: bool = False, donate: bool = True,
                       tier: str = "auto",
                       router: Optional[TierRouter] = None,
                       device=None, **kw) -> ParallelCombiner:
    """Adaptive-tier sketch engine (DESIGN.md §14): device sketch plus a
    ``SequentialSketch`` host mirror behind the tier router."""
    s = ShardedSketch(capacity, c_max=c_max, n_shards=n_shards,
                      topk_max=topk_max, items=items,
                      use_pallas=use_pallas, donate=donate, device=device)
    return adaptive_read_engine(s, SequentialSketch(s.counters()),
                                structure="sketch", tier=tier,
                                router=router, **kw)


def fc_sketch(items=None, **kw) -> ParallelCombiner:
    """Flat-combining host sketch (the baseline tier)."""
    return flat_combining(SequentialSketch(items), **kw)
