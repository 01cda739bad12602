"""Gradients of the linear scans: the plain backward versions against
autograd and against the reference's oracles, and (on a card) the
backward kernels against the plain versions.

``rwkv6_scan_bwd_plain`` and ``rglru_scan_bwd_plain`` are the reverse
recurrences the backward kernels compute (``csrc/rwkv6_scan_bwd.cu``,
``csrc/rglru_scan_bwd.cu``).  Inputs are seeded numpy, in f32; the
reference side is ``jax.vjp`` of ``src/repro/kernels/linear_scan/ref.py``'s
exact scans.  Cases: S not a multiple of the backward's chunk of 64,
S < 16, nonzero initial states, decays near 0 and near 1.  Tolerances,
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


def _rwkv_inputs(shape, decay, seed=0):
    B, S, H, hd = shape
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    w = np.exp(-np.exp(rng.uniform(*decay, shape))).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    dsT = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0, dy, dsT


def _rglru_inputs(shape, decay, seed=0):
    B, S, R = shape
    rng = np.random.default_rng(seed)
    a = np.exp(-np.exp(rng.uniform(*decay, shape))).astype(np.float32)
    b, dhs = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    h0, dhT = (rng.standard_normal((B, R)).astype(np.float32)
               for _ in range(2))
    return a, b, h0, dhs, dhT


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
    r = r.to(torch.bfloat16)
    before = ops.rwkv6_scan_bwd.launches
    got = _autograd(ops.rwkv6_scan, (r, k, v, w, u, s0), (dy, dsT))
    assert ops.rwkv6_scan_bwd.launches == before + 1
    assert got[0].dtype == torch.bfloat16
    want = _autograd(rwkv6_reference, (r.float(), k, v, w, u, s0),
                     (dy, dsT))
    for name, g, x in zip(NAMES6[1:], got[1:], want[1:]):
        _close(g.cpu(), x.cpu(), 1e-5, name)
    a, b, h0, dhs, dhT = _t(*_rglru_inputs((2, 50, 40), (-3.0, 1.0)),
                            device=cuda)
    before = ops.rglru_scan_bwd.launches
    got = _autograd(ops.rglru_scan, (a, b, h0), (dhs, dhT))
    assert ops.rglru_scan_bwd.launches == before + 1
    for g, x in zip(got, _autograd(ops.rglru_scan_plain, (a, b, h0),
                                   (dhs, dhT))):
        assert torch.equal(g, x)
