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

``_two_level`` emulates, in torch on the CPU, the arithmetic of the CUDA
kernel's chunked body (``csrc/rwkv6_scan.cu``): chunks of 64 tokens,
blocks of 8, every decay factor a product of w over a token range (no
log, no exp, so neither an overflow nor a clamp), the decay between two
blocks split at the end of the key's block, pairs inside a block summed
directly, and the products as 3xTF32 the way the tensor cores take them
(each f32 operand as big = the f32 itself, which the tensor core
truncates to TF32, and small = x - trunc(x), also truncated).  It is held
to the exact scans at the tolerances above on every case, also past the
plain version's domain (where that overflows) and with decays of 0.

The ``gpu`` test holds the CUDA kernels against the plain versions on the
card: ``rglru_scan`` bit for bit, ``rwkv6_scan`` at the tolerances above,
and past the plain version's domain against the exact scan.
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
from repro_torch.kernels.linear_scan.ops import SHORT_SEQ, rwkv6_scan_body
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


# decays past the plain version's domain (sum |log w| < ~80 over a chunk):
# |log w| = 4 a token (256 a 64-token chunk); RWKV-6's w = exp(-exp(w0))
# with w0 over [-6, 1.5]; the reference test's draw with 5 % exact zeros
PAST_DOMAIN = {
    "logw4": lambda rng, shape: np.full(shape, np.exp(-4.0)),
    "w0mix": lambda rng, shape: np.exp(-np.exp(rng.uniform(-6.0, 1.5,
                                                           shape))),
    "zeros": lambda rng, shape: np.where(
        rng.uniform(size=shape) < 0.05, 0.0,
        np.exp(-np.exp(rng.uniform(-3.0, 0.5, shape)))),
}


def _rwkv_inputs(seed, B, S, H, hd, *, decay=None, zero_u_s0=False):
    """r, k, v standard normal; log w = -exp(U(-3, 0.5)) as the
    reference's test draws it (or a fixed decay, or one of
    ``PAST_DOMAIN``'s draws by name); u and state0 normal."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    if decay is None:
        w = np.exp(-np.exp(rng.uniform(-3.0, 0.5, (B, S, H, hd))))
    elif isinstance(decay, str):
        w = PAST_DOMAIN[decay](rng, (B, S, H, hd))
    else:
        w = np.full((B, S, H, hd), decay)
    u = rng.standard_normal((H, hd))
    s0 = rng.standard_normal((B, H, hd, hd))
    if zero_u_s0:
        u, s0 = np.zeros_like(u), np.zeros_like(s0)
    return [np.asarray(a, np.float32) for a in (r, k, v, w, u, s0)]


def _rwkv_close(y, sT, yr, sr):
    y, sT, yr, sr = (np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                else a, np.float32) for a in (y, sT, yr, sr))
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
# RWKV-6: the CUDA kernel's chunked arithmetic, emulated
# ---------------------------------------------------------------------------
T_CHUNK, L_BLOCK = 64, 8           # csrc/rwkv6_scan.cu: chunk::T, chunk::L


def _trunc(x):
    """The TF32 a tensor core reads from an f32 register: the low 13
    mantissa bits dropped (truncation)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm3(a, b, *, a_exact=False, b_exact=False, passes=3):
    """``a @ b`` as the kernel's 3xTF32 mma: each operand as big = x (read
    as trunc(x)) and small = x - trunc(x) (read truncated), the products
    small·big + big·small + big·big summed in f32; an operand exact in TF32
    (bf16 v) drops its small half's product.  ``passes=1`` is one plain
    TF32 product."""
    ab, bb = _trunc(a), _trunc(b)
    out = ab @ bb
    if passes == 1:
        return out
    if not a_exact:
        out = out + _trunc(a - ab) @ bb
    if not b_exact:
        out = out + ab @ _trunc(b - bb)
    return out


def _two_level(r, k, v, w, u, s0, *, v_exact=False, passes=3):
    """The chunked body of ``rwkv6_scan.cu`` on CPU tensors ((B, S, H, hd)
    inputs as ``rwkv6_scan``; f32 math): per chunk of T_CHUNK tokens
    (a tail padded with decay 1 and zero inputs) and blocks of L_BLOCK,

    - Pf, Pr: products of w inside a block before / after each token, G
      the block's total; P_I the product over the blocks before I (P_NB =
      D, the chunk's), X_J over the blocks after J, M_IJ over the blocks
      strictly between J and I — each a running product, every factor
      at most 1;
    - pairs inside a block: r_t·k_s times a running product of w over the
      tokens between them, and r_t·u·k_t on the diagonal (CUDA cores);
    - pairs in blocks J < I: (r Pf)_t M_IJ · (k Pr)_s, one 3xTF32 product
      a block pair (the split at the end of J);
    - y = (r Pf P) S + A v, S = D S + (k Pr X)^T v (3xTF32)."""
    B, S, H, hd = r.shape
    T, L = T_CHUNK, L_BLOCK
    nb, n = T // L, -(-S // T) * T

    def bhsd(x, value=0.0):
        x = x.float().permute(0, 2, 1, 3)
        return torch.nn.functional.pad(x, (0, 0, 0, n - S), value=value)

    rt, kt, vt, wt = bhsd(r), bhsd(k), bhsd(v), bhsd(w, 1.0)
    uf = u.float()[None, :, None, None, :]
    st = s0.float().clone()
    y = torch.empty((B, H, n, hd))
    for c0 in range(0, n, T):
        rc, kc, vc, wc = (x[:, :, c0:c0 + T] for x in (rt, kt, vt, wt))
        rb, kb, wb = (x.reshape(B, H, nb, L, hd) for x in (rc, kc, wc))
        pf, pr = torch.ones_like(wb), torch.ones_like(wb)
        for e in range(1, L):
            pf[..., e, :] = pf[..., e - 1, :] * wb[..., e - 1, :]
        for e in range(L - 2, -1, -1):
            pr[..., e, :] = pr[..., e + 1, :] * wb[..., e + 1, :]
        G = pf[..., L - 1, :] * wb[..., L - 1, :]         # (B, H, nb, hd)
        P = [torch.ones_like(G[:, :, 0])]
        for I in range(nb):
            P.append(P[-1] * G[:, :, I])
        X = [torch.ones_like(G[:, :, 0])] * nb
        for J in range(nb - 1, 0, -1):
            X[J - 1] = X[J] * G[:, :, J]
        qh = (rb * pf).reshape(B, H, T, hd)
        kh = (kb * pr).reshape(B, H, T, hd)
        blocks = torch.zeros((B, H, nb, L, L))
        idx = torch.arange(L)
        blocks[..., idx, idx] = (rb * uf * kb).sum(-1)
        rp = rb.clone()
        for d in range(1, L):                # key d tokens before the query
            blocks[..., idx[d:], idx[:L - d]] = (
                rp[..., d:, :] * kb[..., :L - d, :]).sum(-1)
            rp[..., d:, :] = rp[..., d:, :] * wb[..., :L - d, :]
        A = torch.zeros((B, H, T, T))
        for I in range(nb):
            rows = slice(I * L, (I + 1) * L)
            A[:, :, rows, rows] = blocks[:, :, I]
            for J in range(I):
                m = torch.ones_like(G[:, :, 0])
                for Jb in range(J + 1, I):
                    m = m * G[:, :, Jb]
                A[:, :, rows, J * L:(J + 1) * L] = _mm3(
                    qh[:, :, rows] * m[:, :, None],
                    kh[:, :, J * L:(J + 1) * L].transpose(-1, -2),
                    passes=passes)
        qa = qh * torch.stack(P[:nb], 2).repeat_interleave(L, 2)
        kx = kh * torch.stack(X, 2).repeat_interleave(L, 2)
        y[:, :, c0:c0 + T] = (_mm3(qa, st, passes=passes)
                              + _mm3(A, vc, b_exact=v_exact, passes=passes))
        st = P[nb][..., None] * st + _mm3(kx.transpose(-1, -2), vc,
                                          b_exact=v_exact, passes=passes)
    return y[:, :, :S].permute(0, 2, 1, 3).contiguous(), st


def test_tf32_split_reconstructs_f32():
    """big + small is the f32 value exactly before the tensor core reads
    them, and the small half's truncation costs under 2^-20 of it."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    big = _trunc(x)
    small = x - big
    assert torch.equal(big + small, x)
    assert bool((big - x).abs().le(x.abs() * 2.0 ** -10).all())
    assert bool((_trunc(small) + big - x).abs().le(x.abs() * 2.0 ** -20)
                .all())


@pytest.mark.parametrize("B,S,H,hd,chunk", RWKV_CASES)
def test_rwkv6_two_level_matches_exact_scans(B, S, H, hd, chunk):
    """The kernel's arithmetic against both exact scans, f32 inputs and
    bf16-valued r, k, v (v then exact in TF32: two passes)."""
    arrs = _rwkv_inputs(B * 1000 + S + 7, B, S, H, hd)
    t = [torch.from_numpy(a) for a in arrs]
    want = [rwkv6_reference(*t),
            jax_rwkv6_ref(*(jnp.asarray(a) for a in arrs))]
    got = _two_level(*t)
    for yr, sr in want:
        _rwkv_close(*got, yr, sr)
    tb = [x.bfloat16().float() for x in t[:3]] + t[3:]
    got = _two_level(*tb, v_exact=True)
    _rwkv_close(*got, *rwkv6_reference(*tb))


@pytest.mark.parametrize("decay", sorted(PAST_DOMAIN))
def test_rwkv6_two_level_holds_past_the_domain(decay):
    """Decays the chunked plain form cannot take: the kernel's arithmetic
    stays finite and within the tolerances of both exact scans."""
    arrs = _rwkv_inputs(5, 1, 200, 2, 64, decay=decay)
    t = [torch.from_numpy(a) for a in arrs]
    tb = [x.bfloat16().float() for x in t[:3]] + t[3:]
    y, sT = _two_level(*tb, v_exact=True)
    assert bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
    _rwkv_close(y, sT, *rwkv6_reference(*tb))
    nb = [np.asarray(x) for x in tb]
    _rwkv_close(y, sT, *jax_rwkv6_ref(*(jnp.asarray(a) for a in nb)))


@pytest.mark.parametrize("decay", ["logw4", "zeros"])
def test_rwkv6_plain_fails_past_the_domain(decay):
    """Why the kernel is held to the exact scan there: the TPU kernel's
    single-level chunked form (the plain version) multiplies k by
    exp(-cumsum log w), which overflows at |log w| = 4 (256 a chunk), and
    takes log 0 with decays of 0."""
    arrs = _rwkv_inputs(5, 1, 200, 2, 64, decay=decay)
    t = [torch.from_numpy(a) for a in arrs]
    y, sT = rwkv6_scan_plain(*t, chunk=64)
    yr, sr = rwkv6_reference(*t)
    finite = bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
    assert not finite or float((y - yr).abs().max()) > \
        1e-4 * float(yr.abs().max())


def test_rwkv6_one_tf32_pass_misses_the_tolerance():
    """Why 3xTF32: the same arithmetic with one TF32 product a product
    (~1e-3 relative) falls outside the checks' 1e-4."""
    B, S, H, hd, _ = RWKV_CASES[5]
    t = [torch.from_numpy(a) for a in _rwkv_inputs(3, B, S, H, hd)]
    y, sT = _two_level(*t, passes=1)
    yr, sr = rwkv6_reference(*t)
    assert float((y - yr).abs().max()) > 1e-4 * float(yr.abs().max())


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
    c = torch.empty((1, 4, 2, 16))
    for body in ("step", "chunk"):       # the bodies alone: the card only
        with pytest.raises(ValueError, match="CUDA tensors"):
            rwkv6_scan_body(body, c, c, c, c, torch.empty((2, 16)),
                            torch.empty((1, 2, 16, 16)))
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
    # both bodies around their limit (SHORT_SEQ) and the chunk's tails,
    # rows the chunked body stages by plain loads (hd 12 in bf16, views one
    # element into their storage), a nonzero state0 at the serving prefill
    # shape; past the plain version's domain against the exact scan only
    cases = [((2, S, 4, 64), None) for S in
             (SHORT_SEQ - 1, SHORT_SEQ + 1, 63, 65, 127)]
    cases += [((2, 100, 3, 12), None), ((2, 100, 3, 64), "offset"),
              ((8, 512, 40, 64), None)]
    cases += [((2, 256, 4, 64), d) for d in sorted(PAST_DOMAIN)]
    for i, ((B, S, H, hd), decay) in enumerate(cases):
        arrs = _rwkv_inputs(200 + i, B, S, H, hd,
                            decay=None if decay == "offset" else decay)
        t = [torch.from_numpy(a).to(cuda) for a in arrs]
        for dt in (torch.float32, torch.bfloat16):
            rkvw = [x.to(dt) for x in t[:3]] + [t[3]]
            if decay == "offset":
                rkvw = [torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:]
                        .view(x.shape) for x in rkvw]
                assert rkvw[0].data_ptr() % 16
            y, sT = rwkv6_scan(*rkvw, *t[4:])
            assert bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
            _rwkv_close(y.cpu(), sT.cpu(), *rwkv6_reference(*rkvw, *t[4:]))
            if decay in (None, "offset"):
                _rwkv_close(y.cpu(), sT.cpu(),
                            *rwkv6_scan_plain(*rkvw, *t[4:], chunk=64))
    for i, (B, S, R, chunk) in enumerate(RGLRU_CASES):
        t = [torch.from_numpy(x).to(cuda) for x in _rglru_inputs(i, B, S, R)]
        before = rglru_scan.launches
        hs, hT = rglru_scan(*t, chunk=chunk)
        assert rglru_scan.launches == before + 1
        ps, pT = rglru_scan_plain(*t)
        assert torch.equal(hs, ps) and torch.equal(hT, pT)
    # the ragged layouts of rglru_scan.cu's ring: R not a multiple of 4, a
    # view one element into its storage, S = 1, S not a multiple of a
    # stage's steps, B x R below one CTA's channels, a last tile of 8
    for i, ((B, S, R), offset) in enumerate((
            ((1, 100, 50), False), ((2, 77, 2560), True),
            ((2, 1, 2560), False), ((1, 200, 2560), False),
            ((1, 50, 12), False), ((2, 100, 40), False))):
        t = [torch.from_numpy(x).to(cuda)
             for x in _rglru_inputs(300 + i, B, S, R)]
        if offset:
            t[:2] = [torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:]
                     .view(x.shape) for x in t[:2]]
            assert t[0].data_ptr() % 16
        hs, hT = rglru_scan(*t)
        for ws, wT in (rglru_scan_plain(*t), rglru_reference(*t)):
            assert torch.equal(hs, ws) and torch.equal(hT, wT)
