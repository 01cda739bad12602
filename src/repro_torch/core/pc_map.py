"""Parallel-combining ordered map (§3.3 wired over the batched map).

The port of ``repro.core.pc_map``.  The map is the read-dominated
workload par excellence (lookups + range queries, paper §5.1 setting),
so the combining wrapper is the ``batched_read_optimized`` transform: the
combiner applies the update list as device passes
(``update_batch_async`` — result masks stay on the device and ride the
read fetch) and answers the whole read list with ONE vectorized
``read_batch`` pass.  CLIENT_CODE is empty on the host: the vector lanes
already did the searches.

``fc_map`` is the host flat-combining baseline over the sequential
sorted map.  Every device engine takes ``device=None``, which means the
card (``"cuda"``).
"""
from __future__ import annotations

from typing import Optional, Tuple

from .batched_map import ShardedMap
from .combining import ParallelCombiner, TierRouter
from .flat_combining import flat_combining
from .read_opt import (MegapassCombiner, adaptive_read_engine,
                       batched_read_optimized)
from .seq_map import SequentialSortedMap


def pc_map(m: ShardedMap, **kw) -> ParallelCombiner:
    """§3.3 batched-read combining over a device-resident map.

    ``use_megapass=True`` (DESIGN.md §17) runs each pass's update and
    read rounds as ONE ``mixed_rounds`` dispatch instead of the
    alternating update-dispatch/read-dispatch pair."""
    return batched_read_optimized(m, **kw)


def pc_megapass_map(capacity: int, c_max: int, n_shards: int = 4,
                    key_range: Optional[Tuple[float, float]] = None,
                    items=None, use_pallas: bool = False,
                    donate: bool = True, rounds_cap: int = 8,
                    use_megapass: bool = True,
                    device=None) -> MegapassCombiner:
    """Async megapass map engine (DESIGN.md §17): a
    :class:`~repro_torch.core.read_opt.MegapassCombiner` command queue
    over the K-sharded map — up to ``rounds_cap`` alternating update/read
    combining rounds per dispatch.  ``use_megapass=False`` is the
    alternating-dispatch ablation twin."""
    return MegapassCombiner(
        ShardedMap(capacity, c_max=c_max, n_shards=n_shards,
                   key_range=key_range, items=items, use_pallas=use_pallas,
                   donate=donate, device=device),
        rounds_cap=rounds_cap, use_megapass=use_megapass)


def pc_sharded_map(capacity: int, c_max: int, n_shards: int = 4,
                   key_range: Optional[Tuple[float, float]] = None,
                   items=None, use_pallas: bool = False,
                   donate: bool = True, fault_plan=None, guard=None,
                   device=None, **kw) -> ParallelCombiner:
    """Parallel combining over the K-sharded batched map (DESIGN.md §13).

    ``donate=False`` is the copy-per-pass ablation (DESIGN.md §10);
    ``use_pallas`` is kept for API parity (the device picks the merge
    path).  ``fault_plan``/``guard`` thread the DESIGN.md §15
    fault-tolerance layer through both the map (transactional dispatch)
    and the combining engine (lease takeover).  ``use_megapass`` rides
    through to :func:`pc_map` (DESIGN.md §17)."""
    if fault_plan is not None:
        kw.setdefault("fault_plan", fault_plan)
    return pc_map(ShardedMap(capacity, c_max=c_max, n_shards=n_shards,
                             key_range=key_range, items=items,
                             use_pallas=use_pallas, donate=donate,
                             fault_plan=fault_plan, guard=guard,
                             device=device), **kw)


def pc_adaptive_map(capacity: int, c_max: int, n_shards: int = 4,
                    key_range: Optional[Tuple[float, float]] = None,
                    items=None, use_pallas: bool = False,
                    donate: bool = True, tier: str = "auto",
                    router: Optional[TierRouter] = None, device=None,
                    **kw) -> ParallelCombiner:
    """Adaptive-tier map engine (DESIGN.md §14): the K-sharded device map
    plus a ``SequentialSortedMap`` host mirror behind the tier router —
    per pass, the §3.3 combiner routes to whichever tier the online cost
    model says is cheaper (``tier`` pins a static override)."""
    m = ShardedMap(capacity, c_max=c_max, n_shards=n_shards,
                   key_range=key_range, items=items,
                   use_pallas=use_pallas, donate=donate, device=device)
    return adaptive_read_engine(m, SequentialSortedMap(m.items()),
                                structure="map", tier=tier, router=router,
                                **kw)


def fc_map(items=None, **kw) -> ParallelCombiner:
    """Flat-combining host sorted map (the baseline tier)."""
    return flat_combining(SequentialSortedMap(items), **kw)
