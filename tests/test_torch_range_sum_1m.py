"""``range_sum`` at the map's 10⁶ keys: the port against the JAX package.

Both answer ``range_sum`` as a difference of f32 prefix sums (the
reference's formula, ``src/repro/core/batched_map.py:329-333``, copied at
``src/repro_torch/core/batched_map.py``), so an answer's rounding
follows the prefix magnitude P it is a difference of, not the answer.
Here 10⁶ distinct keys on ``chip_smoke.py``'s grid over [0, 1000), values
uniform in [0, 10), K = 4 key-range shards (P up to ~2.5 M), and 321
answers from widths of 0.01 to the whole range go through the reference's
``ShardedMap`` and the port's on the CPU, beside a float64 oracle.

- Every answer of the port is within 4·eps_f32·P of the reference's and
  of the float64 answer, and so is every answer of the reference: the
  rounding of the shared formula, summed in another order (measured on
  this seed: port–reference 1.51·eps·P at most, on 179 of the 321
  answers; each against float64 at most 1.15·eps·P).
- The reference's own ``_result_ok`` tolerance, 1e-3 + 1e-5·|want|, does
  not hold for its own answers at this size: on this seed 65 of its
  answers and 49 of the port's are outside it.  The fault is the
  reference's formula, which the port copies (ROADMAP C).
"""
import numpy as np

from repro.core.batched_map import ShardedMap as JMap
from repro_torch.core import batched_map as tbm

N = 1_000_000
BOUNDS = (0.0, 250.0, 500.0, 750.0, 1000.0)     # the K = 4 shards' ranges
EPS = float(np.finfo(np.float32).eps)
LIMIT = 4.0                                     # in eps_f32 · P


def _answers_and_scales(keys, vals, queries):
    """The float64 answers and, per query, P: over the shards the range
    touches, the float64 prefix sums of |value| at both ends."""
    order = np.argsort(keys)
    ks, vs = keys[order], vals[order].astype(np.float64)
    cum = np.concatenate([[0.0], np.cumsum(vs)])
    shards = []
    for s in range(4):
        m = (ks >= BOUNDS[s]) & ((ks < BOUNDS[s + 1]) if s < 3 else True)
        shards.append((ks[m], np.concatenate([[0.0], np.cumsum(
            np.abs(vs[m]))])))
    exact, scale = [], []
    for a, b in queries:
        i = np.searchsorted(ks, np.float32(a), "left")
        j = np.searchsorted(ks, np.float32(b), "right")
        exact.append(cum[j] - cum[i])
        p = 0.0
        for kk, cc in shards:
            ii = np.searchsorted(kk, np.float32(a), "left")
            jj = np.searchsorted(kk, np.float32(b), "right")
            if jj > ii:
                p += cc[jj] + cc[ii]
        scale.append(max(p, 1.0))
    return np.asarray(exact), np.asarray(scale)


def test_range_sum_at_a_million_keys_matches_the_reference():
    rng = np.random.default_rng(0)
    grid = np.unique(np.linspace(0.0, 1000.0, 8 * N, endpoint=False)
                     .astype(np.float32))
    keys = np.sort(rng.choice(grid, N, replace=False))
    vals = rng.uniform(0, 10, N).astype(np.float32)
    items = list(zip(keys.tolist(), vals.tolist()))
    kw = dict(c_max=16, n_shards=4, key_range=(0.0, 1000.0), items=items)
    ref = JMap(260_000, **kw)
    port = tbm.ShardedMap(260_000, device="cpu", **kw)
    lo = rng.uniform(0, 1000, 320).astype(np.float32)
    width = rng.choice([0.01, 1.0, 50.0, 500.0, 1000.0], 320)
    queries = [(float(a), float(min(a + w, 1000.0)))
               for a, w in zip(lo, width)] + [(0.0, 1000.0)]
    methods = ["range_sum"] * len(queries)
    got = np.asarray(port.read_batch(methods, queries))
    want = np.asarray(ref.read_batch(methods, queries))
    exact, scale = _answers_and_scales(keys, vals, queries)
    assert np.all(np.abs(got - want) <= LIMIT * EPS * scale)
    assert np.all(np.abs(got - exact) <= LIMIT * EPS * scale)
    assert np.all(np.abs(want - exact) <= LIMIT * EPS * scale)
    # the reference's own tolerance fails on its own answers here
    tol = 1e-3 + 1e-5 * np.abs(exact)
    assert np.sum(np.abs(want - exact) > tol) > 0
