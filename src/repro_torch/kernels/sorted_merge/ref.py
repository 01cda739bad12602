"""Oracle for the sorted-merge (merge-compact) kernel (a copy of the
reference's ``kernels/sorted_merge/ref.py``: the port keeps its own).

``merge_compact_reference`` is the element-wise twin of one merge pass in
plain numpy: drop the entries of sorted run A whose ``keep`` flag is off,
merge the survivors with the valid prefix of sorted run B, and pad the
tail with ``(+inf, +inf)``.  The CUDA kernel, the plain PyTorch version
and this oracle must agree bit-exactly (the merge moves f32 values
without any arithmetic) for every shard count — the same contract as
``kernels/label_prop``.

Preconditions (enforced by the batched-map caller, asserted here):

* the kept subsequence of ``a_keys`` is strictly increasing (A is a
  sorted unique-key array; keep is a subset mask);
* ``b_keys[:b_count]`` is strictly increasing;
* no key appears in both the kept-A set and the valid-B prefix (the map
  only adds keys that are absent), so cross-run ties cannot happen;
* all valid keys are finite (+inf is the padding sentinel) and no value
  is NaN.
"""
from __future__ import annotations

import numpy as np


def merge_compact_reference(a_keys, a_vals, a_keep, b_keys, b_vals,
                            b_count):
    """Merge the kept entries of A with the valid prefix of B (numpy).

    Returns ``(m_keys, m_vals)`` of length ``len(a_keys)``: the merged
    pairs ascending by key, padded with ``(+inf, +inf)``.
    """
    a_keys = np.asarray(a_keys, np.float32)
    a_vals = np.asarray(a_vals, np.float32)
    a_keep = np.asarray(a_keep, bool)
    b_keys = np.asarray(b_keys, np.float32)
    b_vals = np.asarray(b_vals, np.float32)
    n = a_keys.shape[0]
    pairs = [(k, v) for k, v, m in zip(a_keys, a_vals, a_keep) if m]
    pairs += [(b_keys[j], b_vals[j]) for j in range(int(b_count))]
    assert len(pairs) <= n, "merged run overflows the output width"
    keys = [p[0] for p in pairs]
    assert len(set(keys)) == len(keys), "duplicate key across runs"
    pairs.sort(key=lambda t: t[0])
    m_keys = np.full((n,), np.inf, np.float32)
    m_vals = np.full((n,), np.inf, np.float32)
    for i, (k, v) in enumerate(pairs):
        m_keys[i] = k
        m_vals[i] = v
    return m_keys, m_vals
