"""The profiler's trace reduced to what the per-layer metrics read.

A traced stretch is taken with ``torch.profiler`` (CPU and CUDA
activity) and read from its raw events: each device event (kernel,
copy, set) is an interval on the card, each CPU op an interval on the
host.  The device is busy where at least one of its intervals lies:
overlapping kernels count once (the union of the intervals), so the busy
time can never pass the stretch's length.  Nothing is written to disk.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]          # seconds, on the profiler's clock


def union_length(intervals: Sequence[Interval]) -> float:
    """Seconds covered by at least one interval."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: Sequence[Interval], lo: float,
         hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Trace:
    """One traced stretch: ``device`` events as (name, start, end), host
    ``ops`` as (name, start, end), and the stretch [t0, t1]."""

    device: List[Tuple[str, float, float]] = field(default_factory=list)
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return union_length([(max(a, self.t0), min(b, self.t1))
                             for _, a, b in self.device
                             if b > self.t0 and a < self.t1])

    def idle_share(self) -> Optional[float]:
        if not self.device or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s() / self.window_s

    def kernels(self, match) -> List[Tuple[str, float, float]]:
        """Device events whose name ``match(name)`` accepts."""
        return [e for e in self.device if match(e[0])]

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle gaps of the card, each named by the
        innermost host op running at its middle ("no host op" if none)."""
        out = []
        longest = sorted(gaps([(a, b) for _, a, b in self.device], self.t0,
                              self.t1), key=lambda g: g[0] - g[1])[:n]
        for a, b in longest:
            mid = 0.5 * (a + b)
            inner = None
            for name, s, e in self.ops:
                if s <= mid <= e and (inner is None
                                      or e - s < inner[2] - inner[1]):
                    inner = (name, s, e)
            out.append([inner[0] if inner else "no host op", b - a])
        return out


def _ns(ev, what: str) -> float:
    return getattr(ev, f"{what}_ns")() * 1e-9


def from_profiler(prof) -> Trace:
    """A :class:`Trace` of a stopped ``torch.profiler.profile``; the
    stretch is [first event, last event]."""
    tr = Trace()
    for ev in prof.profiler.kineto_results.events():
        dt = str(ev.device_type())
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if "CUDA" in dt:
            tr.device.append((ev.name(), start, end))
        elif "CPU" in dt and not ev.is_user_annotation():
            tr.ops.append((ev.name(), start, end))
    starts = [a for _, a, _ in tr.device + tr.ops]
    ends = [b for _, _, b in tr.device + tr.ops]
    tr.t0 = min(starts) if starts else 0.0
    tr.t1 = max(ends) if ends else 0.0
    return tr


def launch_counts() -> Dict[str, int]:
    """Every ``<kernel>.launches`` counter of the port's loaded kernels."""
    out = {}
    for mname, mod in list(sys.modules.items()):
        if not mname.startswith("repro_torch.kernels.") or mod is None:
            continue
        for attr in dir(mod):
            n = getattr(getattr(mod, attr, None), "launches", None)
            if isinstance(n, int):
                out[attr] = n
    return out


class Tracer:
    """Profiles one stretch of a run: :meth:`start` and :meth:`stop` from
    the thread that launches its work, and :meth:`result` (the
    :class:`Trace`, read from the profiler's events) once the window has
    closed."""

    def __init__(self):
        self.trace: Optional[Trace] = None
        self.wall_s = 0.0
        self.launches: Dict[str, int] = {}    # counter deltas over it
        self._prof = None

    def register(self) -> None:
        """One empty profile from this thread, so that a profile started
        later from another thread finds the profiler set up."""
        from torch.profiler import ProfilerActivity, profile

        import torch

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            pass

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._before = launch_counts()
        self._prof.start()
        self._t = time.perf_counter()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t
        self._prof.stop()
        after = launch_counts()
        self.launches = {k: v - self._before.get(k, 0)
                         for k, v in after.items()}
        self._done, self._prof = self._prof, None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def result(self) -> Optional[Trace]:
        if self.trace is None and getattr(self, "_done", None) is not None:
            self.trace = from_profiler(self._done)
            self._done = None
        return self.trace
