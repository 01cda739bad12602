"""The port's label-propagation kernel against the JAX reference.

On the CPU ``propagate`` runs its plain PyTorch version; it is held
element-wise (exact: labels are only compared and moved) against the
reference's XLA twin ``label_step_xla``, its Pallas kernel in interpret
mode (``label_step(..., n_shards=K, interpret=True)``), the numpy oracles
of ``kernels/label_prop/ref.py`` and the reference's ``connected_components``
/ ``merge_labels``, on the same seeded numpy graphs, at every iteration
of a fixpoint.  The ``gpu`` test holds the CUDA kernel against the plain
version on the card and skips without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.label_prop import ops as jops
from repro.kernels.label_prop.ref import (components_reference,
                                          label_step_reference)
from repro_torch.kernels import label_prop
from repro_torch.kernels.label_prop import ref as tref
from repro_torch.kernels.label_prop.ops import (label_step_plain, propagate,
                                                propagate_plain)

N = 48


def graph(seed, n=N):
    """Seeded edges: random pairs, (0,0) padding, self-loops, duplicates,
    a chain segment, and isolated vertices past n - 8."""
    rng = np.random.default_rng(seed)
    E = int(rng.integers(0, 3 * n // 2))
    eu = rng.integers(0, n - 8, E)
    ev = rng.integers(0, n - 8, E)
    eu[rng.random(E) < 0.15] = 0
    ev[eu == 0] = 0
    loop = rng.random(E) < 0.1
    ev[loop] = eu[loop]
    if E > 4:
        eu[-2:], ev[-2:] = eu[:2], ev[:2]                  # duplicates
    start = int(rng.integers(0, n // 2))
    chain = np.arange(start, start + 6)
    eu = np.concatenate([eu, chain[:-1]]).astype(np.int32)
    ev = np.concatenate([ev, chain[1:]]).astype(np.int32)
    return eu, ev


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


@pytest.mark.parametrize("seed", range(6))
def test_plain_step_equals_reference_steps_at_every_iteration(seed):
    eu, ev = graph(seed)
    l = np.arange(N, dtype=np.int32)
    for _ in range(4 * N):
        got = label_step_plain(_t(l), _t(eu), _t(ev)).numpy()
        xla = np.asarray(jops.label_step_xla(jnp.asarray(l), jnp.asarray(eu),
                                             jnp.asarray(ev)))
        np.testing.assert_array_equal(got, xla)
        np.testing.assert_array_equal(got, label_step_reference(l, eu, ev))
        np.testing.assert_array_equal(got, tref.label_step_reference(l, eu,
                                                                     ev))
        # the dispatching wrapper (max_iters = 1) on a CPU tensor
        np.testing.assert_array_equal(
            label_prop.label_step(_t(l), _t(eu), _t(ev)).numpy(), got)
        if np.array_equal(got, l):
            break
        l = got
    else:
        pytest.fail("no fixpoint")


@pytest.mark.parametrize("K", [1, 2, 4])
def test_plain_step_equals_pallas_kernel_in_interpret_mode(K):
    eu, ev = graph(10 + K)
    l = np.arange(N, dtype=np.int32)
    while True:
        got = label_step_plain(_t(l), _t(eu), _t(ev)).numpy()
        pallas = np.asarray(jops.label_step(
            jnp.asarray(l), jnp.asarray(eu), jnp.asarray(ev), n_shards=K,
            interpret=True))
        np.testing.assert_array_equal(got, pallas)
        if np.array_equal(got, l):
            break
        l = got


@pytest.mark.parametrize("seed", range(4))
def test_plain_fixpoint_equals_reference_connected_components(seed):
    eu, ev = graph(20 + seed)
    got = label_prop.connected_components(_t(eu), _t(ev), n=N).numpy()
    want = components_reference(N, zip(eu.tolist(), ev.tolist()))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tref.components_reference(
        N, zip(eu.tolist(), ev.tolist())))
    for use_pallas in (False, True):
        j = np.asarray(jops.connected_components(
            jnp.asarray(eu), jnp.asarray(ev), n=N, n_shards=2,
            use_pallas=use_pallas, interpret=True))
        np.testing.assert_array_equal(got, j)


@pytest.mark.parametrize("seed", range(4))
def test_plain_merge_labels_equals_reference(seed):
    eu, ev = graph(30 + seed)
    k = len(eu) // 2
    base = components_reference(N, zip(eu[:k].tolist(), ev[:k].tolist()))
    bu, bv = eu[k:k + 12], ev[k:k + 12]
    got = label_prop.merge_labels(_t(base), _t(bu), _t(bv), n=N).numpy()
    want = np.asarray(jops.merge_labels(jnp.asarray(base), jnp.asarray(bu),
                                        jnp.asarray(bv), n=N))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, components_reference(
        N, zip(eu[:k + 12].tolist(), ev[:k + 12].tolist())))
    # a no-op batch: (0,0) slots only, and no edge at all
    zeros = np.zeros(5, np.int32)
    for u, v in ((zeros, zeros), (zeros[:0], zeros[:0])):
        got = label_prop.merge_labels(_t(base), _t(u), _t(v), n=N).numpy()
        np.testing.assert_array_equal(got, base)
        if u.size:
            np.testing.assert_array_equal(got, np.asarray(jops.merge_labels(
                jnp.asarray(base), jnp.asarray(u), jnp.asarray(v), n=N)))


def test_propagate_options_match_their_definitions():
    """valid masks and live counts sanitize to (0,0); the gates decide;
    relabel is merge_labels; max_iters counts steps."""
    eu, ev = graph(40)
    E = len(eu)
    rng = np.random.default_rng(41)
    valid = rng.random(E) < 0.6
    junk_u, junk_v = eu.copy(), ev.copy()
    junk_u[~valid] = rng.integers(0, N, (~valid).sum())
    junk_v[~valid] = rng.integers(0, N, (~valid).sum())
    out = torch.empty(N, dtype=torch.int32)
    steps = propagate(_t(junk_u), _t(junk_v), out,
                      valid=torch.from_numpy(valid))
    want = components_reference(N, zip(eu[valid].tolist(),
                                       ev[valid].tolist()))
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(steps) >= 1
    # live prefix on a tensor count
    k = E // 3
    out = torch.empty(N, dtype=torch.int32)
    propagate(_t(eu), _t(ev), out, e_live=torch.tensor(k, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), components_reference(
        N, zip(eu[:k].tolist(), ev[:k].tolist())))
    # gates: nothing happens unless when and not unless
    base = torch.from_numpy(want.copy())
    for kw in (dict(when=torch.tensor(False)),
               dict(unless=torch.tensor(True))):
        o = base.clone()
        assert int(propagate(_t(eu), _t(ev), o, **kw)) == 0
        assert torch.equal(o, base)
    # relabel == merge_labels; an empty live set is the identity
    o = base.clone()
    propagate(_t(eu), _t(ev), o, relabel=True,
              unless=torch.tensor(False))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jops.merge_labels(
        jnp.asarray(want), jnp.asarray(eu), jnp.asarray(ev), n=N)))
    o = base.clone()
    assert int(propagate(_t(eu), _t(ev), o, relabel=True,
                         e_live=torch.tensor(0, dtype=torch.int32))) == 0
    assert torch.equal(o, base)
    # max_iters: two single steps == one two-step launch
    l1 = torch.empty(N, dtype=torch.int32)
    propagate(_t(eu), _t(ev), l1, max_iters=1)
    l2 = torch.empty(N, dtype=torch.int32)
    propagate(_t(eu), _t(ev), l2, init=l1, max_iters=1)
    both = torch.empty(N, dtype=torch.int32)
    assert int(propagate(_t(eu), _t(ev), both, max_iters=2)) == 2
    assert torch.equal(both, l2)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_cuda_kernel_equals_plain_version(cuda, seed):
    eu, ev = graph(50 + seed, n=4096)
    eu_t, ev_t = _t(eu).to(cuda), _t(ev).to(cuda)
    l = torch.arange(4096, dtype=torch.int32, device=cuda)
    while True:
        got, want = torch.empty_like(l), torch.empty_like(l)
        propagate(eu_t, ev_t, got, init=l, max_iters=1)
        propagate_plain(eu_t, ev_t, want, init=l, max_iters=1)
        assert torch.equal(got, want)
        if torch.equal(got, l):
            break
        l = got
    full = torch.empty_like(l)
    propagate(eu_t, ev_t, full)
    assert torch.equal(full, l)
    merged = full.clone()
    propagate(eu_t[:7], ev_t[:7], merged, relabel=True)
    assert torch.equal(merged, full)
