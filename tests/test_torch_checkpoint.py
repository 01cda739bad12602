"""The port's checkpoints: atomic, keep-K, auto-resume, async — and the
reference's on-disk format, so a checkpoint crosses between the packages
in both directions, bf16 bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.optim import adamw_init as jinit
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.models import convert, transformer
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.tree import leaves, tree_map


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn(6, 4, generator=g).to(torch.bfloat16),
              "stack": ({"w": torch.randn(2, 3, 3, generator=g)},
                        {"w": torch.randn(2, 3, generator=g)
                         .to(torch.bfloat16)}),
              "final_norm": torch.randn(4, generator=g)}
    return {"params": params, "opt": adamw_init(params)}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _bits_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


def test_keys_are_the_references():
    keys = list(_flatten(_tree()))
    assert "opt/.step" in keys and "opt/.m/embed" in keys
    assert "opt/.v/stack/0/w" in keys and "params/stack/1/w" in keys


def test_round_trip_and_manifest(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 7, tree, extra={"loss": 1.5})
    assert os.path.basename(path) == "step_0000000007"
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    meta = manifest["arrays"]["params/embed"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [6, 4]
    assert meta["file"] == "params__embed.npy"
    assert np.load(os.path.join(path, meta["file"])).dtype == np.uint16
    assert latest_step(str(tmp_path)) == 7
    got, extra = load_checkpoint(str(tmp_path), 7, _zeros_like(tree))
    assert extra == {"loss": 1.5}
    _bits_equal(got, tree)


def test_load_checks_keys_and_shapes(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="missing"):
        load_checkpoint(str(tmp_path), 1, {"b": torch.ones(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path), 1, {"a": torch.ones(4)})


def test_stale_tmp_is_ignored_and_collected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree())
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))
    assert latest_step(d) == 3
    CheckpointManager(d)
    assert sorted(os.listdir(d)) == ["step_0000000003"]


def test_keep_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        m.save(step, _tree(step))
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]


def test_restore_latest_skips_an_invalid_directory(tmp_path):
    d = str(tmp_path)
    m = CheckpointManager(d)
    assert m.restore_latest(_tree()) is None
    m.save(5, _tree(5))
    m.save(6, _tree(6))
    os.remove(os.path.join(d, "step_0000000006", "params__embed.npy"))
    os.makedirs(os.path.join(d, "step_0000000008"))          # no manifest
    with open(os.path.join(d, "step_0000000007"), "w") as f:  # not a dir
        f.write("junk")
    step, got, _ = m.restore_latest(_zeros_like(_tree()))
    assert step == 5
    _bits_equal(got, _tree(5))


def test_async_save_keeps_the_values_at_save_time(tmp_path):
    """The in-place AdamW step straight after ``save(blocking=False)``
    must not reach the checkpoint being written."""
    tree = _tree()
    want = tree_map(torch.clone, tree)
    m = CheckpointManager(str(tmp_path))
    m.save(1, tree, blocking=False)
    params, opt = tree["params"], tree["opt"]
    for _ in range(3):
        grads = tree_map(torch.ones_like, params)
        params, opt, _ = adamw_update(params, grads, opt, lr=0.5)
    m.wait()
    assert not torch.equal(params["final_norm"],
                           want["params"]["final_norm"])
    got, _ = load_checkpoint(str(tmp_path), 1, _zeros_like(want))
    _bits_equal(got, want)


def test_write_errors_surface_on_wait(tmp_path):
    m = CheckpointManager(str(tmp_path))
    # a file where the write's temporary directory goes: the write fails
    with open(tmp_path / "step_0000000002.tmp", "w") as f:
        f.write("junk")
    m.save(2, {"a": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError):
        m.wait()
    m.wait()                                 # reported once


def _model_trees():
    """A reduced Qwen2's parameters and AdamW state in both packages,
    leaf for leaf the same (bf16 weights carried bit for bit)."""
    from repro.models import transformer as jt
    jc = __import__("repro.configs", fromlist=["x"]).get_reduced(
        "qwen2_0_5b")
    jp, _ = jt.model_init(jax.random.PRNGKey(0), jc)
    jo = jinit(jp)
    jo = jo._replace(m=jax.tree.map(lambda a: a + 0.25, jo.m),
                     step=jnp.int32(4))
    cfg = configs.get_reduced("qwen2_0_5b")
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
    to = adamw_init(tp)
    to = to._replace(m=tree_map(lambda a: a + 0.25, to.m),
                     step=torch.tensor(4, dtype=torch.int32))
    return {"params": jp, "opt": jo}, {"params": tp, "opt": to}, cfg


def _same_as_jax(port_tree, jax_tree):
    got = leaves(port_tree)
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert str(g.numpy().dtype) == str(w.dtype)
            np.testing.assert_array_equal(g.numpy(), w)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jtree, _, cfg = _model_trees()
    JManager(str(tmp_path)).save(12, jtree, extra={"loss": 2.0})
    params = transformer.model_init(1, cfg, device="cpu")
    step, got, extra = CheckpointManager(str(tmp_path)).restore_latest(
        {"params": params, "opt": adamw_init(params)})
    assert step == 12 and extra == {"loss": 2.0}
    _same_as_jax(got, jtree)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jtree, ttree, _ = _model_trees()
    CheckpointManager(str(tmp_path)).save(3, ttree, extra={"a": 1})
    empty = jax.tree.map(jnp.zeros_like, jtree)
    step, got, extra = JManager(str(tmp_path)).restore_latest(empty)
    assert step == 3 and extra == {"a": 1}
    _same_as_jax(ttree, got)
