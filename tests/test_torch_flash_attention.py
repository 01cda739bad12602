"""The port's flash attention against the reference's, on the CPU.

``flash_attention_plain`` (the kernel's plain PyTorch version) is held
against the JAX ``flash_attention`` — its Pallas kernel in interpret mode,
as ``tests/test_kernels.py`` runs it — and against the JAX
``attention_reference``, on the same seeded numpy inputs.  Tolerances are
the reference's own (``test_kernels.py:57``): 2e-5 absolute and relative
in float32 (the two sum in different orders), 2e-2 in bfloat16 (one
output rounding in bf16, ~2^-8 relative, on values up to ~3).  The ``gpu``
test holds the CUDA kernel against the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import attention_reference as jax_ref
from repro_torch.kernels import flash_attention as fa_pkg
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import attention_reference

# tests/test_kernels.py:34-43 (ATTN_CASES), dtypes by name
ATTN_CASES = [
    # B, Sq, Skv, H, K, hd, causal, window, cap, dtype
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 64, 64, 4, 4, 32, True, 0, 50.0, "float32"),
    (2, 64, 256, 8, 2, 64, False, 0, 0.0, "float32"),
    (1, 256, 256, 4, 1, 64, True, 64, 0.0, "float32"),
    (1, 96, 96, 2, 2, 16, True, 32, 30.0, "float32"),   # ragged blocks
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, "bfloat16"),
    (1, 33, 65, 2, 1, 8, True, 0, 0.0, "float32"),      # odd sizes → pad
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the bf16 kernel against its plain version, row by row: ||got - want|| /
# ||want|| over each output row's hd_v values, at 4 times bf16's 2^-8 (the
# P and output roundings give ~2^-9).  A long row's output is small
# (~sqrt(e / n) at n keys, 0.026 at 4,096) against TOL's 2e-2 atol; a tile
# of 64 keys too many or too few there moves it by ~8 / sqrt(n), 12 %.
ROW_TOL = 2 ** -6
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, B, Sq, Skv, H, K, hd, dtype, hd_v=None):
    """Seeded numpy inputs, rounded once to ``dtype`` so that both
    packages start from the same values."""
    hd_v = hd if hd_v is None else hd_v
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd_v))]
    arrs = [np.asarray(jnp.asarray(a, JNP[dtype]).astype(jnp.float32))
            for a in arrs]
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]
    return jx, tx


def _row_err(got, want):
    """The largest ||got - want|| / ||want|| over the output rows."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else jnp.asarray(got, jnp.float32), np.float32),
        np.asarray(want.float() if isinstance(want, torch.Tensor)
                   else jnp.asarray(want, jnp.float32), np.float32),
        atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "B,Sq,Skv,H,K,hd,causal,window,cap,dtype", ATTN_CASES)
def test_plain_matches_jax_flash_and_reference(B, Sq, Skv, H, K, hd, causal,
                                               window, cap, dtype, rng):
    (jq, jk, jv), (q, k, v) = _inputs(rng, B, Sq, Skv, H, K, hd, dtype)
    kw = dict(causal=causal, window=window, cap=cap)
    before = flash_attention.launches
    got = flash_attention(q, k, v, block_q=32, block_k=32, **kw)
    assert flash_attention.launches == before       # the CPU runs no kernel
    assert got.dtype == q.dtype and got.shape == (B, Sq, H, hd)
    tol = TOL[dtype]
    _close(got, jax_flash(jq, jk, jv, block_q=32, block_k=32, **kw), tol)
    _close(got, jax_ref(jq, jk, jv, **kw), tol)
    _close(attention_reference(q, k, v, **kw), jax_ref(jq, jk, jv, **kw),
           tol)
    # the kernel's own tiles and the model's default ones sweep the same
    # function
    for bq in (64, 128):
        _close(flash_attention_plain(q, k, v, block_q=bq, block_k=bq, **kw),
               got, tol)


def test_plain_q_offset(rng):
    """tests/test_kernels.py::test_flash_attention_q_offset."""
    (jq, jk, jv), (q, k, v) = _inputs(rng, 1, 8, 32, 2, 2, 16, "float32")
    got = flash_attention_plain(q, k, v, causal=True, q_offset=24,
                                block_q=8, block_k=8)
    _close(got, jax_flash(jq, jk, jv, causal=True, q_offset=24, block_q=8,
                          block_k=8), 2e-5)
    _close(got, jax_ref(jq, jk, jv, causal=True, q_offset=24), 2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_kv_len_prefix(causal, rng):
    """``kv_len < Skv``: slots past the valid prefix are masked, as the
    JAX kernel masks them (its ``kv_len`` argument, interpret mode) and as
    attention over the prefix alone computes."""
    B, Sq, Skv, H, K, hd, kv_len = 2, 40, 64, 4, 2, 16, 37
    (jq, jk, jv), (q, k, v) = _inputs(rng, B, Sq, Skv, H, K, hd, "float32")
    got = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                q_offset=24, block_q=16, block_k=16)
    want = flash_attention_bhsd(
        jnp.pad(jnp.moveaxis(jq, 2, 1), ((0, 0), (0, 0), (0, 8), (0, 0))),
        jnp.moveaxis(jk, 2, 1), jnp.moveaxis(jv, 2, 1), causal=causal,
        kv_len=kv_len, q_offset=24, block_q=16, block_k=16, interpret=True)
    _close(got, jnp.moveaxis(want, 1, 2)[:, :Sq], 2e-5)
    _close(got, jax_ref(jq, jk[:, :kv_len], jv[:, :kv_len], causal=causal,
                        q_offset=24), 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_value_width_differs_from_key_width(dtype, rng):
    (jq, jk, jv), (q, k, v) = _inputs(rng, 1, 48, 48, 4, 2, 16, dtype,
                                      hd_v=24)
    got = flash_attention_plain(q, k, v, causal=True, block_q=16,
                                block_k=16)
    assert got.shape == (1, 48, 4, 24)
    _close(got, jax_flash(jq, jk, jv, causal=True, block_q=16, block_k=16),
           TOL[dtype])
    _close(got, jax_ref(jq, jk, jv, causal=True), TOL[dtype])


@pytest.mark.parametrize("q_offset", [0, 40])
def test_plain_window_first_tile_fully_masked(q_offset, rng):
    """A window narrower than a tile: for the last rows of a q tile the
    first visited KV tile is fully masked (p = exp(0) = 1 on its masked
    entries until the next tile's corr = 0 wipes them).  The finite
    sentinel keeps every row finite and equal to the reference."""
    B, Sq, H, K, hd, window, blk = 1, 64, 2, 1, 16, 8, 32
    Skv = Sq + q_offset
    (jq, jk, jv), (q, k, v) = _inputs(rng, B, Sq, Skv, H, K, hd, "float32")
    kw = dict(causal=True, window=window, cap=30.0, q_offset=q_offset)
    # rows whose first visited KV tile (the reference's skip rule) holds
    # no key inside their window
    hit = 0
    for row in range(Sq):
        q_lo = row // blk * blk + q_offset
        first = next(j for j in range(Skv // blk)
                     if j * blk + blk - 1 >= q_lo - window + 1)
        pos = row + q_offset
        hit += all(not (pos - window < c <= pos)
                   for c in range(first * blk, first * blk + blk))
    assert hit > 0
    got = flash_attention_plain(q, k, v, block_q=blk, block_k=blk, **kw)
    assert bool(torch.isfinite(got).all())
    _close(got, jax_flash(jq, jk, jv, block_q=blk, block_k=blk, **kw), 2e-5)
    _close(got, jax_ref(jq, jk, jv, **kw), 2e-5)


@pytest.mark.parametrize("layout", ["aligned", "stride", "base"])
def test_bf16_layout_check(layout):
    """The bf16 kernel's layout rule, checked before any launch: each base
    pointer 16-byte aligned and each stride a multiple of 8 elements.
    The f32 kernel takes the same views."""
    width, lo = {"aligned": (72, 0), "stride": (70, 0),
                 "base": (72, 1)}[layout]
    for dt in (torch.bfloat16, torch.float32):
        view = torch.zeros((2, 16, 4, width), dtype=dt)[..., lo:lo + 64]
        want = (16 * 4 * width, 4 * width, width)
        if layout == "aligned" or dt == torch.float32:
            assert fa_pkg.ops._strides(view, "q") == want
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                fa_pkg.ops._strides(view, "q")


@pytest.mark.parametrize("window,cap", [(4096, 50.0), (2048, 0.0)])
@pytest.mark.parametrize("off", [-64, 64])
def test_row_check_rejects_a_tile_off_at_a_long_window_edge(window, cap,
                                                             off, rng):
    """ROW_TOL, the bf16 kernel's row check, fails every row of an output
    whose window admits one 64-key tile too many or too few at gemma2's
    (4,096, softcap 50) and RecurrentGemma's (2,048) window, hd 256; the
    correct output, rounded to bf16, is within a quarter of it of the f32
    math on the same inputs."""
    q_offset, Sq, H, hd = window + 64, 64, 2, 256
    _, (q, k, v) = _inputs(rng, 1, Sq, q_offset + Sq, H, 1, hd, "bfloat16")
    kw = dict(causal=True, cap=cap, q_offset=q_offset, block_q=128,
              block_k=64)
    want = flash_attention_plain(q, k, v, window=window, **kw)
    wrong = flash_attention_plain(q, k, v, window=window + off, **kw)
    exact = flash_attention_plain(q.float(), k.float(), v.float(),
                                  window=window, **kw)
    assert _row_err(want, exact) <= ROW_TOL / 4
    g, w = wrong.float(), want.float()
    assert float(((g - w).norm(dim=-1) / w.norm(dim=-1)).min()) > ROW_TOL


def test_wrapper_is_the_package_entry_point():
    assert fa_pkg.flash_attention is flash_attention
    assert fa_pkg.flash_attention_plain is flash_attention_plain


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain f32 einsums
    return torch.device("cuda")


# (B, Sq, Skv, H, K, hd, hd_v, causal, window, cap, q_offset, dtype): the
# CPU cases, then the bf16 kernel's edges — sequences one off its tiles
# (128 query rows, 64 KV slots) at hd 64 and 256, head widths padded to
# an instance (8, 24, 80), MLA's widths (hd 192, hd_v 128), and a window
# narrower than a tile with q_offset, where rows find no unmasked key in
# their first visited tile
GPU_CASES = [c[:6] + (c[5],) + c[6:9] + (0, c[9]) for c in ATTN_CASES + [
    (1, 48, 48, 4, 2, 16, True, 0, 0.0, "float32"),
    (2, 200, 200, 8, 4, 256, True, 64, 50.0, "bfloat16"),   # gemma2 heads
    (1, 130, 130, 4, 1, 80, False, 0, 0.0, "float32"),      # hubert heads
    (1, 100, 100, 4, 2, 128, True, 0, 0.0, "bfloat16"),
]] + [
    (1, 127, 127, 2, 1, 64, 64, True, 0, 0.0, 0, "bfloat16"),
    (1, 128, 128, 2, 1, 64, 64, True, 0, 0.0, 0, "bfloat16"),
    (1, 129, 129, 2, 1, 64, 64, True, 0, 0.0, 0, "bfloat16"),
    (1, 129, 127, 2, 1, 64, 64, False, 0, 0.0, 0, "bfloat16"),
    (1, 63, 63, 2, 1, 256, 256, True, 0, 50.0, 0, "bfloat16"),
    (1, 64, 64, 2, 1, 256, 256, True, 0, 0.0, 0, "bfloat16"),
    (1, 65, 65, 2, 1, 256, 256, True, 16, 0.0, 0, "bfloat16"),
    (1, 129, 129, 2, 1, 256, 256, True, 0, 0.0, 0, "bfloat16"),
    (2, 40, 40, 4, 2, 8, 8, True, 0, 0.0, 0, "bfloat16"),
    (2, 70, 70, 4, 2, 24, 24, True, 0, 0.0, 0, "bfloat16"),
    (1, 130, 130, 4, 1, 80, 80, False, 0, 0.0, 0, "bfloat16"),
    (1, 150, 150, 2, 1, 192, 128, True, 0, 0.0, 0, "bfloat16"),
    (1, 200, 264, 2, 1, 64, 64, True, 24, 30.0, 64, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,Sq,Skv,H,K,hd,hd_v,causal,window,cap,q_offset,dtype", GPU_CASES)
def test_cuda_kernel_equals_plain_version(cuda, B, Sq, Skv, H, K, hd, hd_v,
                                          causal, window, cap, q_offset,
                                          dtype, rng):
    """The kernel of ``dtype`` against the plain version tiled like it
    (``KERNEL_BLOCKS[dtype]``), element by element and, in bf16, row by
    row (ROW_TOL)."""
    _, (q, k, v) = _inputs(rng, B, Sq, Skv, H, K, hd, dtype, hd_v=hd_v)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    bq, bk = fa_pkg.ops.KERNEL_BLOCKS[TORCH[dtype]]
    kw = dict(causal=causal, window=window, cap=cap, q_offset=q_offset)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    want = flash_attention_plain(q, k, v, block_q=bq, block_k=bk, **kw)
    _close(got.cpu(), want.cpu(), TOL[dtype])
    if dtype == "bfloat16":
        assert _row_err(got, want) <= ROW_TOL


@pytest.mark.gpu
def test_cuda_bf16_misaligned_layout_raises(cuda, rng):
    """The bf16 kernel moves 16-byte chunks: a stride that is not a
    multiple of 8 elements, or a base that is not 16-byte aligned, raises,
    and nothing is launched."""
    _, (q, k, v) = _inputs(rng, 1, 32, 32, 2, 1, 64, "bfloat16")
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    wide = torch.zeros((1, 32, 2, 68), dtype=torch.bfloat16, device=cuda)
    wide[..., :64] = q
    odd = torch.zeros((1, 32, 1, 65), dtype=torch.bfloat16, device=cuda)
    odd[..., 1:] = k
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(wide[..., :64], k, v)     # head stride 68
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, odd[..., 1:], v)       # base 2 bytes off
    assert flash_attention.launches == before
