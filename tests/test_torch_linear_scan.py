"""The port's linear scans against the reference's, on the CPU.

``rwkv6_scan`` and ``rglru_scan`` on CPU tensors run their plain versions
(``rwkv6_scan_plain``: the TPU kernel's chunked factored math;
``rglru_scan_plain``: the exact step, a product then a sum).  They are
held against the JAX ``rwkv6_scan`` / ``rglru_scan`` — the Pallas kernels
in interpret mode, as ``tests/test_kernels.py`` runs them — and against
the reference's exact scans ``rwkv6_reference`` / ``rglru_reference``, on
the same seeded numpy inputs (``test_kernels.py:78-124`` and the slice's
extra cases).  The tolerances are the reference's own
(``test_kernels.py:94-96, 121-122``):

- RWKV-6: y within 1e-4 of max|y| (the chunked form against the exact
  scan: cumsums and three products in f32), S_T within atol 1e-3 /
  rtol 1e-4;
- RG-LRU: atol 1e-5 (XLA contracts ``a·h + b`` into an FMA, the port does
  not; the port's plain version equals its own exact oracle bit for bit).

The ``gpu`` test holds the CUDA kernels against the plain versions on the
card: ``rglru_scan`` bit for bit, ``rwkv6_scan`` at the tolerances above.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import rglru_scan as jax_rglru
from repro.kernels.linear_scan import rwkv6_scan as jax_rwkv6
from repro.kernels.linear_scan.ref import rglru_reference as jax_rglru_ref
from repro.kernels.linear_scan.ref import rwkv6_reference as jax_rwkv6_ref
from repro_torch.kernels.linear_scan import (rglru_scan, rglru_scan_plain,
                                             rwkv6_scan, rwkv6_scan_plain)
from repro_torch.kernels.linear_scan.ref import (rglru_reference,
                                                 rwkv6_reference)

# B, S, H, hd, chunk: tests/test_kernels.py:78-79 (S = 100 is not a
# multiple of the chunk), then S = 1 (a decode step) and a chunk longer
# than the sequence
RWKV_CASES = [(2, 128, 2, 16, 32), (1, 100, 3, 32, 64), (2, 64, 1, 8, 64),
              (1, 256, 2, 16, 16), (3, 1, 2, 16, 64), (2, 40, 2, 64, 64)]
# B, S, R, chunk: tests/test_kernels.py:113-114, then S = 1
RGLRU_CASES = [(2, 128, 64, 32), (1, 100, 48, 256), (3, 64, 16, 16),
               (4, 1, 32, 256)]


def _rwkv_inputs(seed, B, S, H, hd, *, decay=None, zero_u_s0=False):
    """r, k, v standard normal; log w = -exp(U(-3, 0.5)) as the
    reference's test draws it (or a fixed decay); u and state0 normal."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    if decay is None:
        w = np.exp(-np.exp(rng.uniform(-3.0, 0.5, (B, S, H, hd))))
    else:
        w = np.full((B, S, H, hd), decay)
    u = rng.standard_normal((H, hd))
    s0 = rng.standard_normal((B, H, hd, hd))
    if zero_u_s0:
        u, s0 = np.zeros_like(u), np.zeros_like(s0)
    return [np.asarray(a, np.float32) for a in (r, k, v, w, u, s0)]


def _rwkv_close(y, sT, yr, sr):
    y, sT, yr, sr = (np.asarray(a, np.float32) for a in (y, sT, yr, sr))
    scale = float(np.abs(yr).max()) + 1e-9
    assert float(np.abs(y - yr).max()) / scale < 1e-4
    np.testing.assert_allclose(sT, sr, atol=1e-3, rtol=1e-4)


def _port_rwkv(arrs, chunk, dtype=torch.float32):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in arrs)
    before = rwkv6_scan.launches
    y, sT = rwkv6_scan(r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0,
                       chunk=chunk)
    assert rwkv6_scan.launches == before          # the CPU runs no kernel
    assert y.dtype == sT.dtype == torch.float32
    assert y.shape == r.shape and sT.shape == s0.shape
    return y.numpy(), sT.numpy()


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,hd,chunk", RWKV_CASES)
def test_rwkv6_plain_matches_jax_kernel_and_reference(B, S, H, hd, chunk):
    arrs = _rwkv_inputs(B * 1000 + S, B, S, H, hd)
    y, sT = _port_rwkv(arrs, chunk)
    jx = [jnp.asarray(a) for a in arrs]
    yk, sk = jax_rwkv6(*jx, chunk=chunk)
    yr, sr = jax_rwkv6_ref(*jx)
    _rwkv_close(y, sT, yk, sk)
    _rwkv_close(y, sT, yr, sr)


def test_rwkv6_strong_decay_domain():
    """Decays at the stiff end of the chunked form's domain (|log w| = 1,
    32 a chunk): ``test_kernels.py::test_rwkv6_strong_decay_domain``."""
    arrs = _rwkv_inputs(7, 1, 64, 2, 16, decay=math.exp(-1.0),
                        zero_u_s0=True)
    y, sT = _port_rwkv(arrs, 32)
    jx = [jnp.asarray(a) for a in arrs]
    _rwkv_close(y, sT, *jax_rwkv6_ref(*jx))
    _rwkv_close(y, sT, *jax_rwkv6(*jx, chunk=32))


def test_rwkv6_bf16_inputs_are_read_as_f32():
    """bf16 r, k, v (the model's dtype): the same values as f32 inputs
    rounded once to bf16, in both packages."""
    arrs = _rwkv_inputs(11, 2, 50, 2, 16)
    for i in range(3):
        arrs[i] = np.array(jnp.asarray(arrs[i], jnp.bfloat16)
                           .astype(jnp.float32))
    y, sT = _port_rwkv(arrs, 16, dtype=torch.bfloat16)
    jx = [jnp.asarray(a) for a in arrs]
    for i in range(3):
        jx[i] = jx[i].astype(jnp.bfloat16)
    _rwkv_close(y, sT, *jax_rwkv6(*jx, chunk=16))
    y32, sT32 = _port_rwkv(arrs, 16)
    np.testing.assert_array_equal(y, y32)
    np.testing.assert_array_equal(sT, sT32)


def test_rwkv6_padding_leaves_the_state_alone():
    """A tail shorter than the chunk is padded with decay 1 and zero
    inputs: S = 100 at chunk 64 gives the unpadded 64 + 36 split's state,
    and the first 64 outputs are the first chunk's."""
    arrs = _rwkv_inputs(13, 1, 100, 2, 16)
    t = [torch.from_numpy(a) for a in arrs]
    y, sT = rwkv6_scan_plain(*t, chunk=64)
    y1, s1 = rwkv6_scan_plain(*(a[:, :64] for a in t[:4]), t[4], t[5],
                              chunk=64)
    y2, s2 = rwkv6_scan_plain(*(a[:, 64:] for a in t[:4]), t[4], s1,
                              chunk=36)
    torch.testing.assert_close(y[:, :64], y1, atol=0, rtol=0)
    torch.testing.assert_close(y[:, 64:], y2, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sT, s2, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,S,H,hd,chunk", RWKV_CASES[:4])
def test_rwkv6_torch_oracle_equals_jax_oracle(B, S, H, hd, chunk):
    arrs = _rwkv_inputs(B * 1000 + S, B, S, H, hd)
    y, sT = rwkv6_reference(*(torch.from_numpy(a) for a in arrs))
    yr, sr = jax_rwkv6_ref(*(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sr), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
def _rglru_inputs(seed, B, S, R):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 1.0, (B, S, R)).astype(np.float32)
    b = rng.standard_normal((B, S, R)).astype(np.float32)
    h0 = rng.standard_normal((B, R)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("B,S,R,chunk", RGLRU_CASES)
def test_rglru_plain_matches_jax_kernel_and_reference(B, S, R, chunk):
    arrs = _rglru_inputs(B * 1000 + S, B, S, R)
    before = rglru_scan.launches
    hs, hT = rglru_scan(*(torch.from_numpy(x) for x in arrs), chunk=chunk)
    assert rglru_scan.launches == before
    assert hs.dtype == hT.dtype == torch.float32
    jx = [jnp.asarray(x) for x in arrs]
    for want_hs, want_hT in (jax_rglru(*jx, chunk=chunk),
                             jax_rglru_ref(*jx)):
        np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs),
                                   atol=1e-5)
        np.testing.assert_allclose(hT.numpy(), np.asarray(want_hT),
                                   atol=1e-5)
    # the port's own exact oracle: the same two roundings, bit for bit
    rs, rT = rglru_reference(*(torch.from_numpy(x) for x in arrs))
    torch.testing.assert_close(hs, rs, atol=0, rtol=0)
    torch.testing.assert_close(hT, rT, atol=0, rtol=0)


@pytest.mark.parametrize("B,S,R,chunk", RGLRU_CASES[:3])
def test_rglru_torch_oracle_equals_jax_oracle(B, S, R, chunk):
    arrs = _rglru_inputs(B * 1000 + S, B, S, R)
    hs, hT = rglru_reference(*(torch.from_numpy(x) for x in arrs))
    want_hs, want_hT = jax_rglru_ref(*(jnp.asarray(x) for x in arrs))
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(want_hT), atol=1e-5)


def test_rglru_plain_rounds_product_then_sum():
    """No FMA: ``(a·h) + b`` with the product rounded first.  With
    a = 1 + 2^-12, h = 1 + 2^-12 and b = -(1 + 2^-11) the rounded product
    cancels b exactly (0), where an FMA keeps the 2^-24 of a·h."""
    a = torch.full((1, 1, 1), 1 + 2 ** -12)
    b = torch.full((1, 1, 1), -(1 + 2 ** -11))
    h0 = torch.full((1, 1), 1 + 2 ** -12)
    hs, hT = rglru_scan_plain(a, b, h0)
    assert float(hs[0, 0, 0]) == 0.0 and float(hT[0, 0]) == 0.0


# ---------------------------------------------------------------------------
# the device picks the path
# ---------------------------------------------------------------------------
def test_tensors_off_cpu_and_cuda_are_refused():
    meta = torch.device("meta")
    x = torch.empty((1, 4, 2, 16), device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rwkv6_scan(x, x, x, x, torch.empty((2, 16), device=meta),
                   torch.empty((1, 2, 16, 16), device=meta))
    a = torch.empty((1, 4, 8), device=meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_scan(a, a, torch.empty((1, 8), device=meta))


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain f32 products
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda):
    for i, (B, S, H, hd, chunk) in enumerate(RWKV_CASES):
        arrs = _rwkv_inputs(i, B, S, H, hd)
        t = [torch.from_numpy(a).to(cuda) for a in arrs]
        for dt in (torch.float32, torch.bfloat16):
            rkv = [x.to(dt) for x in t[:3]]
            before = rwkv6_scan.launches
            y, sT = rwkv6_scan(*rkv, *t[3:], chunk=chunk)
            assert rwkv6_scan.launches == before + 1
            yp, sp = rwkv6_scan_plain(*rkv, *t[3:], chunk=chunk)
            _rwkv_close(y.cpu(), sT.cpu(), yp.cpu(), sp.cpu())
    arrs = _rwkv_inputs(99, 1, 64, 2, 16, decay=math.exp(-1.0),
                        zero_u_s0=True)
    t = [torch.from_numpy(a).to(cuda) for a in arrs]
    y, sT = rwkv6_scan(*t, chunk=32)
    _rwkv_close(y.cpu(), sT.cpu(), *rwkv6_reference(*t))
    for i, (B, S, R, chunk) in enumerate(RGLRU_CASES):
        t = [torch.from_numpy(x).to(cuda) for x in _rglru_inputs(i, B, S, R)]
        before = rglru_scan.launches
        hs, hT = rglru_scan(*t, chunk=chunk)
        assert rglru_scan.launches == before + 1
        ps, pT = rglru_scan_plain(*t)
        assert torch.equal(hs, ps) and torch.equal(hT, pT)
