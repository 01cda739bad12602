"""The benchmark's own arithmetic: roofline bounds, operation counts, the
idle share from overlapping intervals, the tail percentile."""
from __future__ import annotations

import json

import pytest

from portbench import flops, roofline, stats
from portbench.devtrace import Trace, gaps, union_length

from .conftest import REPO


@pytest.mark.parametrize("fn,want_ms", [
    (roofline.rwkv6_scan_bound_s, 0.176852),
    (roofline.rwkv6_scan_bwd_bound_s, 0.377963),
])
def test_rwkv6_scan_bounds_at_the_train_shape(fn, want_ms):
    # (4, 4096, 40, 64), bf16 r/k/v: the bounds PERF's kernel table gives
    assert fn(4, 4096, 40, 64, 2) * 1e3 == pytest.approx(want_ms, abs=5e-7)


def test_rwkv6_forward_operations_count_every_weight_twice():
    c = json.loads((REPO / "portbench/configs/rwkv6-3b.json").read_text())
    D, F, V, L = 2560, 8960, 65536, 32
    weights = L * (5 * D * D + 7 * 32 * D + 2 * D * F + D * D) + D * V
    scan = L * 5 * 40 * 64 * 64
    assert flops.forward_per_token(c, 4096) == 2 * weights + scan
    assert flops.train_per_token(c, 4096) == \
        3 * flops.forward_per_token(c, 4096)


def test_deepseek_counts_active_experts_only():
    c = json.loads((REPO / "portbench/configs/deepseek-v2-lite.json")
                   .read_text())
    base = flops.forward_per_token(c, 2048)
    more = dict(c, n_routed_experts=128)
    # more experts a layer add router columns only, not expert products
    assert flops.forward_per_token(more, 2048) - base == \
        7 * 2 * 2048 * 64
    fewer = dict(c, num_experts_per_tok=5)
    assert base - flops.forward_per_token(fewer, 2048) == \
        7 * 2 * 3 * 2048 * 1408
    # active weights ~0.87 B a token (embedding excluded)
    assert 1.6e9 < base < 2.0e9


def test_overlapping_intervals_count_once():
    assert union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert union_length([]) == 0
    assert gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [(0, 1), (3, 4),
                                                       (5, 6)]


def test_idle_share_never_negative_under_overlap():
    tr = Trace(device=[("a", 0.0, 1.0), ("b", 0.0, 1.0), ("c", 0.5, 1.0)],
               t0=0.0, t1=2.0)
    assert tr.busy_s() == 1.0
    assert tr.idle_share() == 0.5
    assert tr.idle_gaps() == [["no host op", 1.0]]
    tr.ops = [("outer", 0.0, 2.0), ("inner", 1.2, 1.8)]
    assert tr.idle_gaps() == [["inner", 1.0]]


def test_p95_is_the_nearest_rank_over_all_values():
    vals = list(range(1, 201))                       # 200 requests
    assert stats.percentile(vals, 95) == 190         # 10 beyond it
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 95) == 3

