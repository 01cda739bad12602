"""The plain references against the port's plain path (its CPU twins),
at a small size, in f32: the loss, every leaf's gradient, and the
served logits after prefill and decode steps through the cache."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.reference import deepseek_v2, rwkv6
from portbench.reference.common import flatten, tree_to
from portbench.reference.precision import F32

from .conftest import DATA

CASES = [("tiny-rwkv6", rwkv6), ("tiny-deepseek", deepseek_v2)]


def _setup(name, seed=3):
    from repro_torch.models import transformer
    from portbench.harness import Context

    conf = json.loads((DATA / f"{name}.json").read_text())
    ctx = Context.__new__(Context)
    ctx.config = conf
    cfg = Context.arch(ctx)
    params = transformer.model_init(seed, cfg, device="cpu")
    p32 = tree_to(params, lambda t: t.detach().float().clone())
    return conf, cfg, p32


@pytest.mark.parametrize("name,ref", CASES)
def test_loss_and_gradients_match_the_port(name, ref):
    from repro_torch.launch.steps import loss_and_grads

    conf, cfg, p32 = _setup(name)
    mix = {"batch": 2, "seq": 48, "zipf_a": 1.2, "mean_doc_len": 8}
    hb = traffic.train_batch(mix, cfg.vocab, 11, 0)
    batch = {k: torch.from_numpy(v) for k, v in hb.items()}
    loss_p, grads_p = loss_and_grads(p32, cfg, batch)
    W = tree_to(p32, lambda t: t.clone().requires_grad_(True))
    loss_r = ref.loss(W, conf, batch, F32)
    named = flatten(W)
    grads_r = torch.autograd.grad(loss_r, [p for _, p in named],
                                  allow_unused=True)
    assert abs(float(loss_p) - float(loss_r.detach())) < 1e-5
    for (n, p), g_r, (_, g_p) in zip(named, grads_r, flatten(grads_p)):
        g_r = torch.zeros_like(p) if g_r is None else g_r
        scale = float(g_r.abs().max()) + 1e-12
        assert float((g_p - g_r).abs().max()) / scale < 1e-3, n


@pytest.mark.parametrize("name,ref", CASES[:1])
def test_served_logits_match_the_port(name, ref):
    """Left-padded prompts prefilled as a batch, then decode steps through
    the cache: every step's logits against one reference pass over each
    padded prompt and its tokens.  RWKV-6 only: the MoE's capacity is per
    call (the prefill's rows, then one token a decode step), which one
    pass over the whole sequence does not reproduce."""
    from repro_torch.launch.serve import DecodeExecutor

    conf, cfg, p32 = _setup(name)
    rng = np.random.default_rng(5)
    reqs = [{"prompt": rng.integers(2, cfg.vocab, n).astype(np.int32),
             "n_tokens": 4} for n in (5, 9, 3)]
    ex = DecodeExecutor(cfg, max_batch=4, max_len=16, device="cpu",
                        params=p32, cache_dtype=torch.float32,
                        keep_logits=True)
    outs = ex(reqs)
    S = max(len(r["prompt"]) for r in reqs)
    for i, (r, out) in enumerate(zip(reqs, outs)):
        seq = np.concatenate([np.zeros(S - len(r["prompt"]), np.int64),
                              r["prompt"], out[:-1]])
        pos = list(range(S - 1, S - 1 + len(out)))
        with torch.no_grad():
            want = ref.logits_at(p32, conf, torch.from_numpy(seq), pos, F32)
        got = torch.stack([lg[i] for lg in ex.step_logits[:len(out)]])
        scale = float(want.abs().max())
        assert float((got.float() - want).abs().max()) / scale < 1e-4


@pytest.mark.parametrize("name,ref", CASES)
def test_the_benchmarks_draw_is_the_ports_layout(name, ref):
    """The weights the benchmark draws for both sides have the port's
    leaves, shapes and dtypes, and from one seed the same numbers as the
    port's own initialiser, so the limits read on those hold."""
    from repro_torch.models import transformer

    conf, cfg, _ = _setup(name)
    ours = flatten(ref.init(conf, 7, "cpu"))
    port = flatten(transformer.model_init(7, cfg, device="cpu"))
    assert [n for n, _ in ours] == [n for n, _ in port]
    for (n, a), (_, b) in zip(ours, port):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        assert torch.equal(a, b), n


@pytest.mark.parametrize("group,same", [("cell", True), ("published", False)])
def test_the_cells_rope_scaling_is_the_ports_rope(group, same):
    """The cell's file runs YaRN at factor 1, which is the plain RoPE the
    port runs: the reference's frequencies, softmax scale and loss then
    equal those with no scaling.  The published factor 40 moves all three
    (cos and sin keep the factor 1: its mscale equals its mscale_all_dim)."""
    cell = json.loads((Path(deepseek_v2.__file__).parents[1] / "configs"
                       / "deepseek-v2-lite.json").read_text())
    rs = (cell["rope_scaling"] if group == "cell"
          else cell["published_values"]["rope_scaling"])
    plain = {k: v for k, v in cell.items() if k != "rope_scaling"}
    freq_p, ms_p = deepseek_v2.rope_freqs(plain)
    freq_y, ms_y = deepseek_v2.rope_freqs(dict(plain, rope_scaling=rs))
    scale_p = deepseek_v2.softmax_scale(plain)
    scale_y = deepseek_v2.softmax_scale(dict(plain, rope_scaling=rs))
    assert torch.allclose(freq_y, freq_p, rtol=1e-15, atol=0) == same
    assert ms_y == ms_p == 1.0
    assert (scale_y == scale_p) == same

    conf, cfg, p32 = _setup("tiny-deepseek")
    mix = {"batch": 2, "seq": 48, "zipf_a": 1.2, "mean_doc_len": 8}
    batch = {k: torch.from_numpy(v) for k, v in
             traffic.train_batch(mix, cfg.vocab, 11, 0).items()}
    with torch.no_grad():
        loss_p = float(deepseek_v2.loss(p32, conf, batch, F32))
        loss_y = float(deepseek_v2.loss(p32, dict(conf, rope_scaling=rs),
                                        batch, F32))
    assert (abs(loss_y - loss_p) < 1e-6 * abs(loss_p)) == same
