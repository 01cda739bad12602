"""Flat combining (§3.2) as the degenerate case of parallel combining.

The combiner sequentially applies every collected request to the underlying
sequential data structure (``combineApply``); clients passively wait
(CLIENT_CODE is empty).  STATUS_SET = {PUSHED, FINISHED}.
"""
from __future__ import annotations

from typing import Any, List, Protocol

from .combining import ParallelCombiner, Request, Status


class SequentialDS(Protocol):
    def apply(self, method: str, input: Any) -> Any:  # pragma: no cover
        ...


def flat_combining(ds: SequentialDS, **kw) -> ParallelCombiner:
    """Build a concurrent structure from sequential ``ds`` via flat combining."""

    def combiner_code(engine: ParallelCombiner, requests: List[Request]) -> None:
        for r in requests:
            r.res = ds.apply(r.method, r.input)
            r.status = Status.FINISHED

    def client_code(engine: ParallelCombiner, r: Request) -> None:
        return  # CLIENT_CODE is empty (§3.2)

    return ParallelCombiner(combiner_code, client_code, **kw)
