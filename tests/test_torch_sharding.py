"""The port's sharding plans (``launch/sharding.py``) against the
reference's, spec by spec, on the CPU.

No process group and no device mesh: the port's specs are computed over a
:class:`~repro_torch.launch.sharding.MeshShape` (axis names and sizes),
the reference's over a JAX ``AbstractMesh`` built as
``tests/test_sharding_launch.py`` builds it, on both production meshes
(16×16 and 2×16×16).  A reference ``PartitionSpec`` is compared as the
tuple it is; every comparison is exact.

- ``param_specs`` for all ten archs, ``train`` and ``serve``: leaf for
  leaf, in the reference's leaf order;
- ``cache_specs`` for every runnable prefill and decode cell, on the
  cell's config as the reference's dry run sets it; the model-level
  ``repro_torch.models.cache_specs`` for the reduced cache of all ten
  archs;
- ``input_specs`` (shapes and dtypes) and ``batch_specs`` for all 40
  cells;
- the reference file's own cases: divisibility, kv-8 caches shard their
  sequence, batch 1 stays unsharded, ``sanitize_specs``, the 40/9 skip
  accounting; and the placements a spec maps to.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import sharding as jsh
from repro_torch import configs as tconfigs
from repro_torch.launch import sharding as tsh
from repro_torch.launch.dryrun import cell_config
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.layers import Spec

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
       jnp.int32: torch.int32}


def _jmesh(name):
    sizes, names = MESHES[name]
    try:
        return AbstractMesh(sizes, names)
    except TypeError:   # jax <= 0.4.x: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(zip(names, sizes)))


def _tmesh(name):
    return tsh.MeshShape(*MESHES[name])


@pytest.fixture(autouse=True)
def _memo_abstract_init(monkeypatch):
    """Both packages' ``abstract_init`` traced once an arch config: the
    spec functions call it on every call."""
    monkeypatch.setattr(jsh, "abstract_init", _jabstract)
    monkeypatch.setattr(tsh, "abstract_init", _tabstract)


_JABSTRACT = jsh.abstract_init
_TABSTRACT = tsh.abstract_init


@functools.lru_cache(maxsize=None)
def _jabstract(cfg):
    return _JABSTRACT(cfg)


@functools.lru_cache(maxsize=None)
def _tabstract(cfg):
    return _TABSTRACT(cfg)


def _jflat(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _tflat(tree):
    out = []

    def rec(t):
        if isinstance(t, Spec):
            out.append(tuple(t))
        elif isinstance(t, dict):
            for k in sorted(t):
                rec(t[k])
        elif isinstance(t, (tuple, list)):
            for v in t:
                rec(v)
    rec(tree)
    return out


def _jshapes(tree):
    return [(tuple(x.shape), _DT[x.dtype.type]) for x in jax.tree.leaves(tree)]


def _tshapes(tree):
    out = []

    def rec(t):
        if isinstance(t, tsh.ShapeDtype):
            out.append((tuple(t.shape), t.dtype))
        elif isinstance(t, dict):
            for k in sorted(t):
                rec(t[k])
        elif isinstance(t, (tuple, list)):
            for v in t:
                rec(v)
    rec(tree)
    return out


def _cells(kinds=None):
    return [(a, s) for a, s, ok, _ in tconfigs.cells()
            if (kinds is None or tconfigs.SHAPES[s].kind in kinds)
            and (ok or kinds is None)]


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mode, mesh):
    want = _jflat(jsh.param_specs(jconfigs.get(arch), _jmesh(mesh), mode))
    got = _tflat(tsh.param_specs(tconfigs.get(arch), _tmesh(mesh), mode))
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_shapes_equal_the_reference(arch):
    """``abstract_init``'s shapes and dtypes, leaf for leaf."""
    assert _tshapes(tsh.param_shapes(tconfigs.get(arch))) == \
        _jshapes(jsh.param_shapes(jconfigs.get(arch)))


@pytest.mark.parametrize("arch,shape", _cells(("prefill", "decode")))
def test_cache_specs_equal_the_reference(arch, shape):
    spec = tconfigs.SHAPES[shape]
    tc = cell_config(arch, shape)
    jc = jconfigs.get(arch).with_(decode_cache_len=spec.seq_len,
                                  remat=False, pure_dp=tc.pure_dp)
    B, S = spec.global_batch, spec.seq_len
    jshapes = jsh.cache_shapes(jc, B, S)
    tshapes = tsh.cache_shapes(tc, B, S)
    assert _tshapes(tshapes) == _jshapes(jshapes)
    for mesh in MESHES:
        assert _tflat(tsh.cache_specs(tc, _tmesh(mesh), tshapes)) == \
            _jflat(jsh.cache_specs(jc, _jmesh(mesh), jshapes)), mesh


@pytest.mark.parametrize("axes", [(("data",), "model"),
                                  (("pod", "data"), None)])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_model_cache_specs_equal_the_reference(arch, axes):
    """``repro_torch.models.cache_specs`` (the model-level specs, by each
    leaf's rank) against the reference's ``transformer.cache_specs`` over
    the reduced config's cache, with TP on and off; and ``ShardCtx`` is
    the package's public name too."""
    from repro.models import transformer as jt
    from repro_torch import models as tmodels

    dp, tensor = axes
    jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    want = _jflat(jt.cache_specs(jc, jt.init_cache(jc, 2, 16), dp, tensor))
    cache = tmodels.init_cache(tc, 2, 16, device="cpu")
    got = _tflat(tmodels.cache_specs(tc, cache, dp, tensor))
    assert len(got) == len(want) > 0
    assert got == want
    # shape stand-ins give the same specs as the tensors
    assert _tflat(tmodels.cache_specs(tc, tsh.cache_shapes(tc, 2, 16), dp,
                                      tensor)) == got
    assert tmodels.ShardCtx is tsh.ShardCtx


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_and_batch_specs_equal_the_reference(arch, shape):
    spec = tconfigs.SHAPES[shape]
    jspec = jconfigs.SHAPES[shape]
    tc, jc = tconfigs.get(arch), jconfigs.get(arch)
    if spec.kind != "train":
        tc = tc.with_(decode_cache_len=spec.seq_len)
        jc = jc.with_(decode_cache_len=spec.seq_len)
    for mesh in MESHES:
        tins = tsh.input_specs(tc, spec, _tmesh(mesh))
        jins = jsh.input_specs(jc, jspec, _jmesh(mesh))
        assert sorted(tins) == sorted(jins)
        for k in tins:
            assert _tshapes(tins[k]) == _jshapes(jins[k]), (mesh, k)
        assert _tflat(tsh.batch_specs(tc, spec, _tmesh(mesh))) == \
            _jflat(jsh.batch_specs(jc, jspec, _jmesh(mesh))), mesh


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_sharding_launch.py), on the port
# ---------------------------------------------------------------------------
def test_mesh_axes_helper():
    dp, tensor, pod = mesh_axes(_tmesh("16x16"))
    assert dp == ("data",) and tensor == "model" and pod is None
    dp, tensor, pod = mesh_axes(_tmesh("2x16x16"))
    assert dp == ("pod", "data") and pod == "pod"


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_specs_divisible(arch):
    """Every resolved spec shards only divisible dims, one entry a dim."""
    cfg = tconfigs.get(arch)
    mesh = _tmesh("16x16")
    shapes = tsh.param_shapes(cfg)
    specs = tsh.param_specs(cfg, mesh, "train")
    flat_sh, flat_sp = _tshapes(shapes), _tflat(specs)
    assert len(flat_sh) == len(flat_sp)
    for (shape, _), s in zip(flat_sh, flat_sp):
        assert len(s) == len(shape)
        for d, ax in enumerate(s):
            if ax is not None:
                axes = ax if isinstance(ax, tuple) else (ax,)
                size = int(np.prod([mesh.size_of(a) for a in axes]))
                assert shape[d] % size == 0, (arch, shape, s)


def test_kv8_cache_shards_seq_not_heads():
    """kv_heads=8 can't split 16 ways → the seq dim takes the model axis."""
    cfg = tconfigs.get("internlm2_20b").with_(decode_cache_len=32768)
    specs = tsh.cache_specs(cfg, _tmesh("16x16"),
                            tsh.cache_shapes(cfg, 128, 32768))
    kv = [s for s in _tflat(specs) if len(s) == 5]   # stacked (L,B,S,K,hd)
    assert kv and all(s[2] == "model" for s in kv)


def test_batch1_not_sharded():
    cfg = tconfigs.get("rwkv6_3b").with_(decode_cache_len=1024)
    spec = tconfigs.ShapeSpec("x", 1024, 1, "decode")
    for s in _tflat(tsh.batch_specs(cfg, spec, _tmesh("16x16"))):
        assert s[0] is None


def test_sanitize_specs_drops_nondivisible():
    shapes = {"w": tsh.ShapeDtype((504, 64), torch.float32)}
    out = tsh.sanitize_specs(shapes, {"w": Spec(("model", "data"))},
                             _tmesh("16x16"))
    assert out["w"] == Spec((None, "data"))


def test_skip_accounting_matches_design():
    """9 skipped cells: 7 long_500k (quadratic) + 2 hubert decode shapes."""
    cells = tconfigs.cells()
    skipped = [(a, s) for a, s, ok, _ in cells if not ok]
    assert len(cells) == 40
    assert len(skipped) == 9
    assert ("hubert_xlarge", "decode_32k") in skipped
    assert ("rwkv6_3b", "long_500k") not in skipped


def test_spec_placements_and_local_shapes():
    """An axis is ``Shard(d)`` on its mesh dim, a tuple of axes ``Shard(d)``
    on each (major first; out of the mesh's order it raises), an absent
    axis ``Replicate()``; a rank's shard divides each dim by its axes."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _tmesh("2x16x16")
    s = Spec((("pod", "data"), None, "model"))
    assert tsh.spec_placements(s, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert tsh.spec_placements(Spec((None,)), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        tsh.spec_placements(Spec((("data", "pod"),)), mesh)
    assert tsh.local_shape((64, 3, 32), s, mesh) == (2, 3, 2)
    shapes = {"a": tsh.ShapeDtype((64, 3, 32), torch.bfloat16),
              "b": tsh.ShapeDtype((7,), torch.float32)}
    specs = {"a": s, "b": Spec((None,))}
    assert tsh.local_bytes(shapes, specs, mesh) == 2 * 3 * 2 * 2 + 7 * 4
