"""Parallel-combining union-find (§3.3 over the batched union-find).

The port of ``repro.core.pc_union_find``.  One combining pass of
``union`` ops lowers onto the contracted label-propagation fixpoint
(``kernels/label_prop``) — the whole batch merges in ONE kernel launch
on the card, with the pre-batch snapshot rule giving every lane a
deterministic result whatever the arrival interleaving.  Reads
(``find`` / ``connected`` / ``components``) are one vectorized gather
pass.  ``fc_union_find`` is the host flat-combining baseline over the
sequential min-label structure.
"""
from __future__ import annotations

from typing import Optional

from .batched_union_find import BatchedUnionFind
from .combining import ParallelCombiner, TierRouter
from .flat_combining import flat_combining
from .read_opt import adaptive_read_engine, batched_read_optimized
from .seq_union_find import SequentialUnionFind


def pc_union_find(uf: BatchedUnionFind, **kw) -> ParallelCombiner:
    """§3.3 batched-read combining over a device-resident union-find."""
    return batched_read_optimized(uf, **kw)


def pc_batched_union_find(n: int, c_max: int = 8, n_shards: int = 1,
                          use_pallas: bool = False, donate: bool = True,
                          fault_plan=None, guard=None, device=None,
                          **kw) -> ParallelCombiner:
    """Parallel combining over the batched union-find (DESIGN.md §16):
    in-place merge passes; ``fault_plan``/``guard`` thread the §15
    transactional layer through structure and engine alike.
    ``device=None`` means the card."""
    if fault_plan is not None:
        kw.setdefault("fault_plan", fault_plan)
    return pc_union_find(BatchedUnionFind(n, c_max=c_max,
                                          n_shards=n_shards,
                                          use_pallas=use_pallas,
                                          donate=donate,
                                          fault_plan=fault_plan,
                                          guard=guard, device=device), **kw)


def pc_adaptive_union_find(n: int, c_max: int = 8, n_shards: int = 1,
                           use_pallas: bool = False, donate: bool = True,
                           tier: str = "auto",
                           router: Optional[TierRouter] = None,
                           device=None, **kw) -> ParallelCombiner:
    """Adaptive-tier union-find engine (DESIGN.md §14): device structure
    plus a state-equal ``SequentialUnionFind`` mirror behind the tier
    router.  The mirror's native ``update_batch`` applies the same
    pre-batch snapshot rule, and the device replays host-served unions in
    a batch of their own (``batch_snapshot``), so both tiers answer as
    the sequential oracle does."""
    uf = BatchedUnionFind(n, c_max=c_max, n_shards=n_shards,
                          use_pallas=use_pallas, donate=donate,
                          device=device)
    host = SequentialUnionFind(uf.n)
    host.load_labels(uf.labels())
    return adaptive_read_engine(uf, host, structure="unionfind",
                                tier=tier, router=router, **kw)


def fc_union_find(n: int, **kw) -> ParallelCombiner:
    """Flat-combining host union-find (the baseline tier)."""
    return flat_combining(SequentialUnionFind(n), **kw)
