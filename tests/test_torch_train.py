"""The port's training path against the reference's, on the CPU.

- ``loss_and_grads`` / ``make_train_step`` for the reduced ``qwen2_0_5b``,
  ``gemma2_2b``, ``rwkv6_3b`` and ``recurrentgemma_2b`` at f32, with the
  reference's ``model_init`` parameters carried by ``models/convert.py``
  (RG-LRU's ``lam`` redrawn so the recurrence carries; see
  ``test_torch_recurrent._jax_params``) and the pipeline's batches: the
  loss, the global norm and every gradient leaf against
  ``jax.value_and_grad(lm.loss_fn)``, then three AdamW steps against the
  reference's jitted ``train_step``.
- ``remat`` and ``attn_remat`` on equal them off, bit for bit, for the
  four models above, the reduced deepseek (MLA, the dense prefix) and
  HuBERT (non-causal frames).
- The other families (MoE, MLA, cross-attention, HuBERT's frames) are
  trained against the reference in ``tests/test_torch_train_families.py``;
  ``blockwise_attention``'s ``attn_remat`` alone in
  ``tests/test_torch_attn_remat.py``.
- The trainer (``launch/train.py`` with ``device="cpu"``): the reference's
  four integration tests (``tests/test_train_integration.py``), a forced
  straggler applied once, the A19 refusals and the CLI.

Tolerances, each with its reason:

- the loss within rtol 1e-5 and each gradient leaf within 1e-4 of its
  max|value|: other summation orders, and on the recurrent models the
  port's chunked plain RWKV-6 scan against the reference's time-step
  scan (1.3e-5 of max|g| measured on ``rwkv6_3b``, ~1e-6 elsewhere);
- the global norm within rtol 1e-4 at the first step; over the three
  steps the loss within rtol 1e-5 and the norm within rtol 1e-3: at
  ``rwkv6_3b``'s third step the norm jumps to ~140 (the random-init
  model's ill-conditioned first positions, u = 0 under the per-head group
  norm, ROADMAP C), and there parameters 2.3e-5 apart give norms 6.5e-4
  apart (measured);
- the parameters after three steps within lr absolute plus rtol 1e-5,
  the moments within 1e-3 of max|m| (they carry each step's clip scale,
  1/gnorm, and so its 1e-3); AdamW divides by sqrt(v), so an
  element whose gradient is ~0 on both sides moves by up to lr a step on
  either, whatever its sign (1.4e-4 at lr 1e-3 measured on
  ``qwen2_0_5b``, 6e-5 on ``rwkv6_3b``).
- The trainer on the CPU is deterministic: a crash and restart ends on
  the uninterrupted run's loss bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import make_pipeline as jpipeline
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import load_checkpoint
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import StragglerWatchdog, main, train, tput_fmt
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw_init
from repro_torch.optim.tree import leaves
from test_torch_families import FAMILIES
from test_torch_families import _batch as _family_batch
from test_torch_families import _jax_params as _family_params
from test_torch_models import _jax_params as _dense_params
from test_torch_recurrent import _jax_params as _recurrent_params

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("qwen2_0_5b", "gemma2_2b", "rwkv6_3b", "recurrentgemma_2b")
LR = 1e-3


@pytest.fixture(autouse=True)
def _two_threads():
    """These tests train models on the CPU beside other test workers; two
    intra-op threads each keep them from starving the workers' other
    tests (the reference's trainer tests time their steps against a 10x
    straggler watchdog).  Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(arch, n_layers=None):
    """The reference's parameters at f32 (numpy-able) and the port's, of
    the reduced config (``n_layers`` deep if given)."""
    make = (_recurrent_params if arch in ("rwkv6_3b", "recurrentgemma_2b")
            else _family_params if arch in FAMILIES else _dense_params)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      make(arch, n_layers) if n_layers else make(arch))
    tc = tconfigs.get_reduced(arch)
    tp = convert.params_from_numpy(
        jax.tree.map(np.asarray, jp),
        tc.with_(n_layers=n_layers) if n_layers else tc, device="cpu")
    return jp, tp


def _batches(arch, n, batch=2, seq=32):
    pipe = jpipeline(jconfigs.get_reduced(arch).vocab, seq, batch, seed=3)
    return [pipe.global_batch(s) for s in range(n)]


def _torch_batch(hb):
    return {k: torch.from_numpy(v) for k, v in hb.items()}


def _train_batch(cfg, hb, seed=0):
    """The pipeline's batch as the trainer shapes it for ``cfg``
    (``launch/train.py``'s ``device_batch``), with seeded frames and image
    embeddings (``test_torch_families._batch``, f32) for both packages:
    HuBERT's frames take the tokens' place, the tokens mod vocab are its
    labels and its mask is ones."""
    hb = dict(hb)
    B, S = hb["tokens"].shape
    _, tb = _family_batch(cfg, seed, B, S, jnp.float32)
    out = _torch_batch(hb)
    if cfg.audio_frontend:
        out["labels"] = out.pop("tokens") % cfg.vocab
        out["frames"] = tb["frames"]
        out["mask"] = torch.ones((B, S), dtype=torch.float32)
    if cfg.n_img_tokens:
        out["image_embeds"] = tb["image_embeds"]
    if not cfg.causal:
        out["labels"] = out["labels"] % cfg.vocab
    return out


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp, tp = _params(arch)
    hb = _batches(arch, 1)[0]
    jl, jg = jax.value_and_grad(lambda p: jlm.loss_fn(
        p, jc, {k: jnp.asarray(v) for k, v in hb.items()}))(jp)
    tl, tg = tsteps.loss_and_grads(tp, tc, _torch_batch(hb))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = leaves(tg)
    assert len(got) == len(want) > 0
    for (path, w), g in zip(want, got):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        err = _rel(g.numpy(), w)
        assert err <= 1e-4, f"{jax.tree_util.keystr(path)}: {err:.3e}"
    # make_train_step reports the same loss and the gradients' norm
    _, tp2 = _params(arch)
    _, _, m = tsteps.make_train_step(tc, lr=LR)(tp2, adamw_init(tp2),
                                               _torch_batch(hb))
    gn = float(jnp.sqrt(sum(jnp.sum(jnp.square(x))
                            for x in jax.tree.leaves(jg))))
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), gn, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_the_reference(arch):
    jc, tc = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp, tp = _params(arch)
    jstep = jax.jit(jmake_train_step(jc, lr=LR))
    tstep = tsteps.make_train_step(tc, lr=LR)
    jo, to = jadamw_init(jp), adamw_init(tp)
    for hb in _batches(arch, 3):
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in hb.items()})
        tp, to, tm = tstep(tp, to, _torch_batch(hb))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                                   rtol=1e-3)
    assert int(to.step) == int(jo.step) == 3
    for g, w in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=LR)
    for g, w in zip(leaves(to.m), jax.tree.leaves(jo.m)):
        assert _rel(g.numpy(), w) <= 1e-3


# arch: the reduced config's depth for the check, None for its own (deepseek
# at 3 layers: the dense prefix and two MoE periods)
REMAT_ARCHS = {"qwen2_0_5b": None, "rwkv6_3b": None, "recurrentgemma_2b": None,
               "gemma2_2b": None, "deepseek_v2_lite_16b": 3,
               "hubert_xlarge": None}


@pytest.mark.parametrize("arch", list(REMAT_ARCHS))
def test_remat_changes_no_bit(arch):
    """``remat`` runs each period under ``torch.utils.checkpoint``, and
    ``attn_remat`` each blockwise-attention chunk pair (a window and
    softcap on gemma2, RecurrentGemma's local layers, deepseek's MLA,
    HuBERT's non-causal frames), the two nested when both are on: the
    recomputed forward is the same computation, so for each of the four
    settings the loss and every gradient are bit-equal to the run that
    keeps every activation."""
    n_layers = REMAT_ARCHS[arch]
    tc = tconfigs.get_reduced(arch)
    if n_layers:
        tc = tc.with_(n_layers=n_layers)
    assert tc.n_full_periods >= 2
    _, tp = _params(arch, n_layers)
    hb = _train_batch(tc, _batches(arch, 1)[0])
    l0, g0 = tsteps.loss_and_grads(
        tp, tc.with_(remat=False, attn_remat=False), hb)
    for remat, attn_remat in ((False, True), (True, False), (True, True)):
        l1, g1 = tsteps.loss_and_grads(
            tp, tc.with_(remat=remat, attn_remat=attn_remat), hb)
        assert torch.equal(l0, l1), (remat, attn_remat)
        for a, b in zip(leaves(g0), leaves(g1)):
            assert torch.equal(a, b), (remat, attn_remat)


def test_flash_attention_refuses_a_gradient():
    """The kernel has no backward (the reference's has none): under grad
    it raises on either device, rather than cutting the gradient; without
    grad it runs; a model with ``attention_impl="pallas"`` cannot be
    trained, and ``xla_chunked`` (the trainer's) can."""
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward.*D1c"):
        flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == (1, 8, 2, 16)
    assert flash_attention(q.detach(), k, v).grad_fn is None
    tc = tconfigs.get_reduced("qwen2_0_5b")
    _, tp = _params("qwen2_0_5b")
    hb = _torch_batch(_batches("qwen2_0_5b", 1)[0])
    with pytest.raises(RuntimeError, match="no backward"):
        tsteps.loss_and_grads(tp, tc.with_(attention_impl="pallas"), hb)
    assert tc.attention_impl == "xla_chunked"


def test_steps_refuse_a_mesh_and_serve_without_grad():
    tc = tconfigs.get_reduced("qwen2_0_5b")
    for make in (tsteps.make_train_step, tsteps.make_prefill_step,
                 tsteps.make_decode_step):
        with pytest.raises(NotImplementedError, match="A19"):
            make(tc, object())
    params = tt.model_init(0, tc, device="cpu")
    cache = tt.init_cache(tc, 2, 16, device="cpu")
    toks = torch.randint(0, tc.vocab, (2, 5))
    logits, cache = tsteps.make_prefill_step(tc)(params, {"tokens": toks},
                                                 cache)
    nxt, cache = tsteps.make_decode_step(tc)(params, cache, 5,
                                             {"tokens": toks[:, -1:]})
    assert logits.shape == (2, tc.vocab) and logits.grad_fn is None
    assert nxt.shape == (2,) and nxt.dtype == torch.int32


# ---------------------------------------------------------------------------
# the trainer: the reference's integration tests on train(device="cpu")
# ---------------------------------------------------------------------------
def test_train_loss_decreases():
    m = train("qwen2_0_5b", steps=30, batch=4, seq=64, lr=1e-3,
              ckpt_dir=None, log_every=100, device="cpu")
    assert m["loss_drop"] > 0.05, m
    assert m["step_ms"] > 0 and m["tokens_per_s"] > 0


def test_crash_restart_continues_identically(tmp_path):
    """Kill at step 12, restart from the step-10 checkpoint, and end on
    the uninterrupted run's final loss — bit for bit on the CPU."""
    d1 = str(tmp_path / "interrupted")
    with pytest.raises(KeyboardInterrupt):
        train("qwen2_0_5b", steps=20, batch=2, seq=32, ckpt_dir=d1,
              ckpt_every=5, fail_at_step=12, log_every=100, device="cpu")
    assert sorted(os.listdir(d1)) == ["step_0000000006",
                                      "step_0000000011"]
    m1 = train("qwen2_0_5b", steps=20, batch=2, seq=32, ckpt_dir=d1,
               ckpt_every=5, log_every=100, device="cpu")
    d2 = str(tmp_path / "clean")
    m2 = train("qwen2_0_5b", steps=20, batch=2, seq=32, ckpt_dir=d2,
               ckpt_every=5, log_every=100, device="cpu")
    assert m1["final_loss"] == m2["final_loss"]


def test_train_with_grad_compress_converges():
    m = train("qwen2_0_5b", steps=20, batch=4, seq=32, lr=1e-3,
              grad_compress=True, log_every=100, device="cpu")
    assert np.isfinite(m["final_loss"])
    assert m["loss_drop"] > 0.0


@pytest.mark.parametrize("arch", ["rwkv6_3b", "gemma2_2b",
                                  "recurrentgemma_2b"])
def test_train_other_families(arch):
    m = train(arch, steps=8, batch=2, seq=32, log_every=100, device="cpu")
    assert np.isfinite(m["final_loss"])


def test_a_straggler_applies_its_batch_once(tmp_path, capsys):
    """``watchdog_factor=0`` makes every step past the warm-up a
    straggler: step 5 is logged and kept, step 6 (the second in a row)
    saves a checkpoint labelled 7 and aborts.  Each batch was applied
    once, so that checkpoint equals a clean 7-step run's."""
    d1, d2 = str(tmp_path / "late"), str(tmp_path / "clean")
    with pytest.raises(RuntimeError, match="straggler abort at step 6"):
        train("qwen2_0_5b", steps=20, batch=2, seq=32, ckpt_dir=d1,
              ckpt_every=100, log_every=100, watchdog_factor=0.0,
              device="cpu")
    out = capsys.readouterr().out
    assert "step 5: straggler" in out and "applied once" in out
    train("qwen2_0_5b", steps=7, batch=2, seq=32, ckpt_dir=d2,
          ckpt_every=100, log_every=100, device="cpu")
    tc = tconfigs.get_reduced("qwen2_0_5b")
    params = tt.model_init(0, tc, device="cpu")
    like = {"params": params, "opt": adamw_init(params)}
    got, extra = load_checkpoint(d1, 7, like)
    want, _ = load_checkpoint(d2, 7, like)
    assert extra == {"abort": "straggler"}
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)


def test_watchdog_and_throughput_format():
    wd = StragglerWatchdog(factor=3.0, warmup=2)
    assert [wd.check(t) for t in (1.0, 1.0, 1.0, 5.0, 1.0)] == [
        False, False, False, True, False]
    assert tput_fmt(1500.0) == "1.5k" and tput_fmt(999.0) == "999"


def test_train_refuses_more_than_one_device():
    for kw in (dict(model_parallel=2), dict(pods=2)):
        with pytest.raises(NotImplementedError, match="A19"):
            train("qwen2_0_5b", steps=1, device="cpu", **kw)


def test_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "qwen2_0_5b", "--steps", "3", "--batch", "2", "--seq",
         "32", "--ckpt-dir", str(tmp_path / "ck")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    done = [ln for ln in r.stdout.splitlines()
            if ln.startswith("[train] done:")]
    m = json.loads(done[0].split(":", 1)[1])
    assert m["steps"] == 3 and np.isfinite(m["final_loss"])
    assert os.listdir(tmp_path / "ck") == ["step_0000000003"]
    # in process, the same flags give the same run
    assert main(["--device", "cpu", "--arch", "qwen2_0_5b", "--steps", "3",
                 "--batch", "2", "--seq", "32"])["final_loss"] \
        == m["final_loss"]
