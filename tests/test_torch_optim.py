"""The port's AdamW and int8 gradient quantizer against the reference's.

Seeded numpy trees (f32 and bf16 leaves, nested dicts and tuples) go
through both.  Tolerances, each with its reason:

- AdamW moments within 1e-6 of the leaf's max|value| and the global norm
  within rtol 1e-6: the same f32 operations in the same order, but XLA
  sums the squares in another order and may contract a product and a sum
  into one FMA, so the clip scale and each term can differ by an ulp; an
  element where ``b1·m`` and ``(1 - b1)·g`` nearly cancel keeps that
  ulp of the terms, not of itself (3.6e-6 of such an element measured).
- f32 parameters within 1e-6 of the leaf's max|value| (the same); bf16
  parameters within one bf16 ulp of the reference's (an f32 difference of
  an ulp can round to the neighbouring bf16).
- The quantizer bit for bit: the max is exact, and the division and the
  round-half-even are correctly rounded on both sides.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jinit
from repro.optim import adamw_update as jupdate
from repro.optim import compress_grads_int8 as jcompress
from repro.optim import decompress_grads_int8 as jdecompress
from repro_torch.models import convert
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               compress_grads_int8, decompress_grads_int8,
                               global_norm)
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.tree import leaves

SHAPES = {"w": ((5, 7), np.float32), "emb": ((6, 4, 5), ml_dtypes.bfloat16),
          "stack": (((3, 4), np.float32), ((2, 3), ml_dtypes.bfloat16)),
          "g": ((9,), np.float32)}


def _tree(rng, scale=1.0, dtype=None):
    def make(spec):
        if isinstance(spec[0], tuple) and isinstance(spec[0][0], tuple):
            return tuple(make(s) for s in spec)
        shape, dt = spec
        return (rng.standard_normal(shape) * scale).astype(dtype or dt)
    return {k: make(v) for k, v in SHAPES.items()}


def _np(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _torch(tree):
    return convert.tree_from_numpy(tree, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def _assert_params(got, want):
    for g, w in zip(got, want):
        if w.dtype == ml_dtypes.bfloat16:
            gf = g.detach().float().numpy()
            wf = w.astype(np.float32)
            ulp = np.abs(np.nextafter(wf.astype(ml_dtypes.bfloat16),
                                      np.float32(np.inf)).astype(np.float32)
                         - wf)
            # one bf16 ulp of the reference's value
            ulp = np.maximum(ulp, np.abs(wf) * 2.0 ** -7)
            assert np.all(np.abs(gf - wf) <= ulp)
        else:
            _close(g.detach().numpy(), w)


@pytest.mark.parametrize("clip_norm", [1.0, 1e6], ids=["clipped", "not"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_matches_the_reference_over_steps(clip_norm, weight_decay):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp, jo = jax.tree.map(jnp.asarray, p0), jinit(p0)
    tp = _torch(p0)
    to = adamw_init(tp)
    assert to.step.dtype == torch.int32 and to.step.shape == ()
    assert all(m.dtype == torch.float32 for m in leaves(to.m))
    for step in range(4):
        g = _tree(rng, scale=3.0)       # gnorm ~ 20: clipped at 1
        kw = dict(lr=1e-2, weight_decay=weight_decay, clip_norm=clip_norm)
        jp, jo, jn = jupdate(jp, jax.tree.map(jnp.asarray, g), jo, **kw)
        before = leaves(tp)
        tp, to, tn = adamw_update(tp, _torch(g), to, **kw)
        assert all(a is b for a, b in zip(before, leaves(tp)))  # in place
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(to.step) == int(jo.step) == step + 1
        for mine, ref in ((to.m, jo.m), (to.v, jo.v)):
            for a, b in zip(leaves(mine), _np(ref)):
                _close(a.numpy(), b)
        _assert_params(leaves(tp), _np(jp))


def test_adamw_slices_of_a_large_leaf_equal_the_whole(monkeypatch):
    """A leaf past ``_SLICE`` elements is updated a run of its leading axis
    at a time; the result is the same bit for bit."""
    rng = np.random.default_rng(1)
    p0, g = _tree(rng), _tree(rng, scale=2.0)
    whole = _torch(p0)
    ow = adamw_update(whole, _torch(g), adamw_init(whole))[1]
    monkeypatch.setattr(tadamw, "_SLICE", 8)
    sliced = _torch(p0)
    os_ = adamw_update(sliced, _torch(g), adamw_init(sliced))[1]
    for a, b in zip(leaves(whole) + leaves(ow.m) + leaves(ow.v),
                    leaves(sliced) + leaves(os_.m) + leaves(os_.v)):
        assert torch.equal(a, b)


def test_global_norm_matches_the_reference():
    from repro.optim import global_norm as jnorm

    g = _tree(np.random.default_rng(2))
    np.testing.assert_allclose(float(global_norm(_torch(g))),
                               float(jnorm(jax.tree.map(jnp.asarray, g))),
                               rtol=1e-6)
    assert isinstance(adamw_init(_torch(g)), AdamWState)


@pytest.mark.parametrize("scale", [1.0, 1e-20, 300.0])
def test_compress_is_bit_equal_to_the_reference(scale):
    rng = np.random.default_rng(3)
    g1, g2 = _tree(rng, scale), _tree(rng, scale)
    jq, js, je = jcompress(jax.tree.map(jnp.asarray, g1))
    tq, ts, te = compress_grads_int8(_torch(g1))
    jq2, js2, je2 = jcompress(jax.tree.map(jnp.asarray, g2), je)
    tq2, ts2, te2 = compress_grads_int8(_torch(g2), te)
    for mine, ref in ((tq, jq), (ts, js), (te, je), (tq2, jq2), (ts2, js2),
                      (te2, je2)):
        got, want = leaves(mine), _np(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.numpy().dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(leaves(decompress_grads_int8(tq2, ts2)),
                    _np(jdecompress(jq2, js2))):
        np.testing.assert_array_equal(a.numpy(), b)
