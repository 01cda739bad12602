"""Gradients of the linear scans: the plain backward versions against
autograd and against the reference's oracles, and (on a card) the
backward kernels against the plain versions.

``rwkv6_scan_bwd_plain`` and ``rglru_scan_bwd_plain`` are the reverse
recurrences the backward kernels compute (``csrc/rwkv6_scan_bwd.cu``,
``csrc/rglru_scan_bwd.cu``).  Inputs are seeded numpy, in f32; the
reference side is ``jax.vjp`` of ``src/repro/kernels/linear_scan/ref.py``'s
exact scans.  Cases: S not a multiple of the backward's chunk
(``ops.BWD_CHUNK``, the kernel's ``kT``) and S at its edges (chunk - 1,
chunk, chunk + 1), S < 16, nonzero initial states, decays near 0 and near
1, and decays of exactly 0 and exactly 1 on chosen steps.  Tolerances,
each with its reason:

- ``rglru_scan_bwd_plain`` equals autograd through ``rglru_scan_plain``
  bit for bit (the same products and sums, one rounding each) and the
  JAX vjp within 1e-6 of each gradient's max|value| (XLA may contract
  ``a·g + dhs`` into one FMA).
- ``rwkv6_scan_bwd_plain`` within 1e-5 of each gradient's max|value| of
  autograd through the exact scan and of the JAX vjp: f32 sums of up to
  64 terms a step, and of S steps, in other orders (~3e-7 measured).
  Against autograd through the chunked ``rwkv6_scan_plain`` (inside its
  decay domain, w in ~(0.05, 0.95)): 1e-4, the chunked form's
  exp/log factors (the forward's own tolerance, tests/test_kernels.py).
- On the card: ``rglru_scan_bwd`` bit for bit, ``rwkv6_scan_bwd`` within
  1e-5 of max|value| of the plain backward (summation order only).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.linear_scan import ops
from repro_torch.kernels.linear_scan.ref import (rglru_reference,
                                                 rwkv6_reference)

# (B, S, H, hd) and the decay draw: log(-log w) ~ U(lo, hi)
RWKV_CASES = [((2, 70, 3, 16), (-3.0, 0.5)),      # S past one chunk
              ((1, 130, 2, 8), (-6.0, 2.0)),      # w near 0 and near 1
              ((2, 9, 2, 16), (-3.0, 0.5)),       # S < 16: a decode step
              ((1, 64, 1, 12), (-8.0, -4.0)),     # w near 1 only, S = chunk
              ((3, 1, 2, 8), (-1.0, 2.0))]        # one step, w near 0
RGLRU_CASES = [((2, 70, 16), (-7.0, 3.0)), ((1, 9, 33), (-3.0, 1.0)),
               ((3, 130, 8), (-9.0, -4.0)), ((1, 1, 5), (0.0, 3.0))]
_T = ops.BWD_CHUNK
# S at the edges of the backward's chunk: the last chunk one step short,
# exactly one chunk (no state saved), one step into a second chunk
RWKV_EDGE_CASES = [((1, _T - 1, 2, 16), (-3.0, 0.5)),
                   ((2, _T, 2, 12), (-6.0, 2.0)),
                   ((1, _T + 1, 3, 8), (-3.0, 0.5))]
# (shape, decay, steps with decays of exactly 0, of exactly 1): a zero on
# a chunk's first and last steps and on the sequence's, a one beside them
RWKV_EXACT_CASES = [((2, 70, 3, 16), (-3.0, 0.5), (0, _T - 1, _T, 69),
                     (5, _T + 1, 2 * _T)),
                    ((1, 9, 2, 8), (-1.0, 2.0), (3,), (4, 8))]
RGLRU_EXACT_CASES = [((2, 70, 16), (-3.0, 1.0), (0, 40, 69), (10, 41)),
                     ((1, 9, 33), (-3.0, 1.0), (8,), (0, 7))]


def _exact(x, zeros, ones):
    """``x`` with, on each step in ``zeros``, every other channel (and the
    whole step on the first) at exactly 0, and on each step in ``ones``
    the other channels at exactly 1."""
    x = x.copy()
    for i, t in enumerate(zeros):
        x[:, t, ..., ::1 if i == 0 else 2] = 0.0
    for t in ones:
        x[:, t, ..., 1::2] = 1.0
    return x


def _rwkv_inputs(shape, decay, seed=0, zeros=(), ones=()):
    B, S, H, hd = shape
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    w = np.exp(-np.exp(rng.uniform(*decay, shape))).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    dsT = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, _exact(w, zeros, ones), u, s0, dy, dsT


def _rglru_inputs(shape, decay, seed=0, zeros=(), ones=()):
    B, S, R = shape
    rng = np.random.default_rng(seed)
    a = np.exp(-np.exp(rng.uniform(*decay, shape))).astype(np.float32)
    b, dhs = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    h0, dhT = (rng.standard_normal((B, R)).astype(np.float32)
               for _ in range(2))
    return _exact(a, zeros, ones), b, h0, dhs, dhT


def _t(*xs, device="cpu"):
    return [torch.from_numpy(x).to(device) for x in xs]


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of max|value| (limit {tol})"


def _autograd(fn, ins, outs_grad):
    leaves = [x.clone().requires_grad_(True) for x in ins]
    outs = fn(*leaves)
    return torch.autograd.grad(outs, leaves, outs_grad)


NAMES6 = ("dr", "dk", "dv", "dw", "du", "dstate0")


@pytest.mark.parametrize("shape,decay", RWKV_CASES)
def test_rwkv6_plain_backward_equals_autograd_of_the_exact_scan(shape,
                                                                decay):
    r, k, v, w, u, s0, dy, dsT = _t(*_rwkv_inputs(shape, decay))
    got = ops.rwkv6_scan_bwd_plain(r, k, v, w, u, s0, dy, dsT)
    want = _autograd(rwkv6_reference, (r, k, v, w, u, s0), (dy, dsT))
    for name, g, x in zip(NAMES6, got, want):
        _close(g, x, 1e-5, name)
    # the chunk the states are saved at changes no bit
    for g, x in zip(got, ops.rwkv6_scan_bwd_plain(r, k, v, w, u, s0, dy,
                                                  dsT, chunk=16)):
        assert torch.equal(g, x)


@pytest.mark.parametrize("shape", [(2, 70, 3, 16), (1, 9, 2, 8)])
def test_rwkv6_plain_backward_equals_autograd_of_the_chunked_plain(shape):
    r, k, v, w, u, s0, dy, dsT = _t(*_rwkv_inputs(shape, (-3.0, 1.0)))
    got = ops.rwkv6_scan_bwd_plain(r, k, v, w, u, s0, dy, dsT)
    want = _autograd(ops.rwkv6_scan_plain, (r, k, v, w, u, s0), (dy, dsT))
    for name, g, x in zip(NAMES6, got, want):
        _close(g, x, 1e-4, name)


@pytest.mark.parametrize("shape,decay", RWKV_CASES)
def test_rwkv6_plain_backward_matches_the_jax_vjp(shape, decay):
    import jax
    import jax.numpy as jnp

    from repro.kernels.linear_scan import ref as jref

    ins = _rwkv_inputs(shape, decay, seed=1)
    _, vjp = jax.vjp(jref.rwkv6_reference, *map(jnp.asarray, ins[:6]))
    want = vjp((jnp.asarray(ins[6]), jnp.asarray(ins[7])))
    got = ops.rwkv6_scan_bwd_plain(*_t(*ins))
    for name, g, x in zip(NAMES6, got, want):
        _close(g, x, 1e-5, name)


def _rwkv6_against_the_jax_vjp(ins):
    import jax
    import jax.numpy as jnp

    from repro.kernels.linear_scan import ref as jref

    _, vjp = jax.vjp(jref.rwkv6_reference, *map(jnp.asarray, ins[:6]))
    want = vjp((jnp.asarray(ins[6]), jnp.asarray(ins[7])))
    got = ops.rwkv6_scan_bwd_plain(*_t(*ins))
    for name, g, x in zip(NAMES6, got, want):
        _close(g, x, 1e-5, name)


@pytest.mark.parametrize("shape,decay", RWKV_EDGE_CASES)
def test_rwkv6_plain_backward_at_the_chunk_edges_matches_the_jax_vjp(
        shape, decay):
    _rwkv6_against_the_jax_vjp(_rwkv_inputs(shape, decay, seed=3))


@pytest.mark.parametrize("shape,decay,zeros,ones", RWKV_EXACT_CASES)
def test_rwkv6_plain_backward_with_exact_decays_matches_the_jax_vjp(
        shape, decay, zeros, ones):
    ins = _rwkv_inputs(shape, decay, seed=4, zeros=zeros, ones=ones)
    assert (ins[3] == 0).any() and (ins[3] == 1).any()
    _rwkv6_against_the_jax_vjp(ins)


def test_the_backward_chunk_mirrors_the_kernel():
    """``ops.BWD_CHUNK`` is ``rwkv6_scan_bwd.cu``'s ``kT``, and the
    wrapper's scratch is one 64 x 64 f32 state a (batch, head) before every
    chunk but the last."""
    src = (Path(ops.__file__).resolve().parents[1] / "csrc" /
           "rwkv6_scan_bwd.cu").read_text()
    assert re.findall(r"constexpr int kT = (\d+);", src) == [
        str(ops.BWD_CHUNK)]
    T = ops.BWD_CHUNK
    for S, n_saved in ((0, 0), (1, 0), (T, 0), (T + 1, 1), (3 * T, 2),
                       (4096, -(-4096 // T) - 1)):
        assert ops.rwkv6_scan_bwd_scratch_bytes(4, S, 40) == \
            4 * 4 * 40 * 64 * 64 * n_saved


def test_rwkv6_plain_backward_without_a_final_state_gradient():
    ins = _t(*_rwkv_inputs((1, 20, 2, 8), (-3.0, 0.5)))
    got = ops.rwkv6_scan_bwd_plain(*ins[:7])
    want = ops.rwkv6_scan_bwd_plain(*ins[:7], torch.zeros_like(ins[7]))
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.parametrize("shape,decay", RGLRU_CASES)
def test_rglru_plain_backward_equals_autograd_bit_for_bit(shape, decay):
    a, b, h0, dhs, dhT = _t(*_rglru_inputs(shape, decay))
    hs, _ = ops.rglru_scan_plain(a, b, h0)
    got = ops.rglru_scan_bwd_plain(a, h0, hs, dhs, dhT)
    want = _autograd(ops.rglru_scan_plain, (a, b, h0), (dhs, dhT))
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    exact = _autograd(rglru_reference, (a, b, h0), (dhs, dhT))
    for name, g, x in zip(("da", "db", "dh0"), got, exact):
        _close(g, x, 1e-6, name)


@pytest.mark.parametrize("shape,decay", RGLRU_CASES)
def test_rglru_plain_backward_matches_the_jax_vjp(shape, decay):
    import jax
    import jax.numpy as jnp

    from repro.kernels.linear_scan import ref as jref

    a, b, h0, dhs, dhT = _rglru_inputs(shape, decay, seed=2)
    (hs, _), vjp = jax.vjp(jref.rglru_reference, *map(jnp.asarray,
                                                      (a, b, h0)))
    want = vjp((jnp.asarray(dhs), jnp.asarray(dhT)))
    got = ops.rglru_scan_bwd_plain(*_t(a, h0, np.array(hs), dhs, dhT))
    for name, g, x in zip(("da", "db", "dh0"), got, want):
        _close(g, x, 1e-6, name)


@pytest.mark.parametrize("shape,decay,zeros,ones", RGLRU_EXACT_CASES)
def test_rglru_plain_backward_with_exact_decays_matches_the_jax_vjp(
        shape, decay, zeros, ones):
    """Decays of exactly 0 and 1: bit for bit against autograd through
    the plain forward, within 1e-6 of the JAX vjp."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.linear_scan import ref as jref

    a, b, h0, dhs, dhT = _rglru_inputs(shape, decay, seed=5, zeros=zeros,
                                       ones=ones)
    assert (a == 0).any() and (a == 1).any()
    (hs, _), vjp = jax.vjp(jref.rglru_reference, *map(jnp.asarray,
                                                      (a, b, h0)))
    want = vjp((jnp.asarray(dhs), jnp.asarray(dhT)))
    ta, tb, th0, tdhs, tdhT = _t(a, b, h0, dhs, dhT)
    ths, _ = ops.rglru_scan_plain(ta, tb, th0)
    got = ops.rglru_scan_bwd_plain(ta, th0, ths, tdhs, tdhT)
    for g, x in zip(got, _autograd(ops.rglru_scan_plain, (ta, tb, th0),
                                   (tdhs, tdhT))):
        assert torch.equal(g, x)
    got = ops.rglru_scan_bwd_plain(*_t(a, h0, np.array(hs), dhs, dhT))
    for name, g, x in zip(("da", "db", "dh0"), got, want):
        _close(g, x, 1e-6, name)


def test_the_wrappers_run_the_plain_backward_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions, counting no
    launch, and the forward stays the differentiable plain version."""
    before = (ops.rwkv6_scan_bwd.launches, ops.rglru_scan_bwd.launches)
    ins = _t(*_rwkv_inputs((1, 20, 2, 8), (-3.0, 0.5)))
    for g, x in zip(ops.rwkv6_scan_bwd(*ins),
                    ops.rwkv6_scan_bwd_plain(*ins)):
        assert torch.equal(g, x)
    a, b, h0, dhs, dhT = _t(*_rglru_inputs((2, 10, 4), (-3.0, 1.0)))
    hs, _ = ops.rglru_scan(a, b, h0)
    for g, x in zip(ops.rglru_scan_bwd(a, h0, hs, dhs, dhT),
                    ops.rglru_scan_bwd_plain(a, h0, hs, dhs, dhT)):
        assert torch.equal(g, x)
    assert (ops.rwkv6_scan_bwd.launches,
            ops.rglru_scan_bwd.launches) == before
    y, _ = ops.rwkv6_scan(*(x.requires_grad_(True) for x in ins[:6]))
    assert y.grad_fn is not None


# ---------------------------------------------------------------------------
# On the card: the backward kernels against the plain backward versions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,decay", RWKV_CASES)
def test_cuda_rwkv6_backward_kernel_matches_plain(cuda, shape, decay, dtype):
    ins = _t(*_rwkv_inputs(shape, decay), device=cuda)
    ins[:3] = [x.to(dtype) for x in ins[:3]]
    before = ops.rwkv6_scan_bwd.launches
    got = ops.rwkv6_scan_bwd(*ins)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan_bwd.launches == before + 1
    for name, g, x in zip(NAMES6, got, ops.rwkv6_scan_bwd_plain(*ins)):
        _close(g.cpu(), x.cpu(), 1e-5, name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,decay,zeros,ones",
                         [(*c, (), ()) for c in RWKV_EDGE_CASES]
                         + RWKV_EXACT_CASES)
def test_cuda_rwkv6_backward_kernel_at_chunk_edges_and_exact_decays(
        cuda, shape, decay, zeros, ones, dtype):
    """The cluster kernel at S = chunk - 1, chunk, chunk + 1 and with
    decays of exactly 0 and 1 (heads of 8, 12 and 16: row groups of the
    cluster without a live row), within 1e-5 of the plain backward."""
    ins = _t(*_rwkv_inputs(shape, decay, seed=6, zeros=zeros, ones=ones),
             device=cuda)
    ins[:3] = [x.to(dtype) for x in ins[:3]]
    got = ops.rwkv6_scan_bwd(*ins)
    torch.cuda.synchronize()
    for name, g, x in zip(NAMES6, got, ops.rwkv6_scan_bwd_plain(*ins)):
        _close(g.cpu(), x.cpu(), 1e-5, name)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,decay,zeros,ones", RGLRU_EXACT_CASES)
def test_cuda_rglru_backward_kernel_with_exact_decays(cuda, shape, decay,
                                                      zeros, ones):
    a, b, h0, dhs, dhT = _t(*_rglru_inputs(shape, decay, seed=7,
                                           zeros=zeros, ones=ones),
                            device=cuda)
    hs, _ = ops.rglru_scan_plain(a, b, h0)
    got = ops.rglru_scan_bwd(a, h0, hs, dhs, dhT)
    for g, x in zip(got, ops.rglru_scan_bwd_plain(a, h0, hs, dhs, dhT)):
        assert torch.equal(g, x)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,decay", RGLRU_CASES)
def test_cuda_rglru_backward_kernel_is_bit_equal_to_plain(cuda, shape,
                                                         decay):
    a, b, h0, dhs, dhT = _t(*_rglru_inputs(shape, decay), device=cuda)
    hs, _ = ops.rglru_scan_plain(a, b, h0)
    got = ops.rglru_scan_bwd(a, h0, hs, dhs, dhT)
    for g, x in zip(got, ops.rglru_scan_bwd_plain(a, h0, hs, dhs, dhT)):
        assert torch.equal(g, x)


@pytest.mark.gpu
def test_cuda_scans_differentiate_through_the_kernels(cuda):
    """Under autograd the CUDA scans' gradients come from the backward
    kernels, one launch a backward, in the inputs' dtypes."""
    r, k, v, w, u, s0, dy, dsT = _t(*_rwkv_inputs((2, 40, 3, 16),
                                                  (-3.0, 0.5)), device=cuda)
    r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))  # one dtype, as
    before = ops.rwkv6_scan_bwd.launches                 # the forward asks
    got = _autograd(ops.rwkv6_scan, (r, k, v, w, u, s0), (dy, dsT))
    assert ops.rwkv6_scan_bwd.launches == before + 1
    assert all(g.dtype == torch.bfloat16 for g in got[:3])
    # dr, dk, dv: the kernel's f32 gradients rounded to the inputs' bf16
    direct = ops.rwkv6_scan_bwd(r, k, v, w, u, s0, dy, dsT)
    for g, x in zip(got[:3], direct[:3]):
        assert torch.equal(g, x.to(torch.bfloat16))
    want = _autograd(rwkv6_reference, (r.float(), k.float(), v.float(), w,
                                       u, s0), (dy, dsT))
    for name, g, x in zip(NAMES6, direct, want):
        _close(g.cpu(), x.cpu(), 1e-5, name)
    a, b, h0, dhs, dhT = _t(*_rglru_inputs((2, 50, 40), (-3.0, 1.0)),
                            device=cuda)
    before = ops.rglru_scan_bwd.launches
    got = _autograd(ops.rglru_scan, (a, b, h0), (dhs, dhT))
    assert ops.rglru_scan_bwd.launches == before + 1
    for g, x in zip(got, _autograd(ops.rglru_scan_plain, (a, b, h0),
                                   (dhs, dhT))):
        assert torch.equal(g, x)
