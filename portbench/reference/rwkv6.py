"""Plain PyTorch RWKV-6 (Finch, arXiv:2404.05892) in float32.

Imports nothing of the port.  Weights come as a tree laid out as the
port's parameters (``embed``, ``stack[0]`` with each leaf stacked over
the layers, ``final_norm``), the benchmark's inputs, and are used as
given in f32.  Departures from the published description, as the
configuration file states: RMSNorm pre-norms and no ln0; one LoRA A
shared by the five token-shift mixes; the head tied to the embedding;
the per-head group norm with eps 1e-5 and no bias.

The recurrence, for each head with state S (hd x hd), decay w_t, bonus u:
``y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)`` and
``S_t = diag(w_t) S_{t-1} + k_t^T v_t``.  :func:`wkv` computes it in
chunks of ``chunk`` steps: the states entering each chunk one after
another, and inside a chunk every pair (t > s) with its decay
``exp(sum_{s<j<t} log w_j)``, which is at most 1, so nothing can
overflow whatever the decay.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Draw, masked_xent, rmsnorm, shift
from .precision import F32, Precision


def wkv(r, k, v, w, u, state0: Optional[torch.Tensor] = None, *,
        chunk: int = 16, head_block: int = 8):
    """r, k, v, w: (B, S, H, hd); u: (H, hd).  Returns y (B, S, H, hd)
    and the final state (B, H, hd, hd), in f32 (f64 from f64 inputs)."""
    B, S, H, K = r.shape
    L = chunk
    pad = (-S) % L
    r, k, v, w = (t if t.dtype == torch.float64 else t.float()
                  for t in (r, k, v, w))
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = (S + pad) // L

    def chunks(t):                          # (B, H, n, L, K)
        return t.reshape(B, n, L, H, K).permute(0, 3, 1, 2, 4)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    # log w floored at -60: a decay below e^-60 leaves nothing an f32
    # state can hold, and the floor keeps w = 0 from making -inf - -inf
    lw = torch.clamp(torch.log(chunks(w)), min=-60.0)
    A = torch.cumsum(lw, dim=3)             # sum of log w up to t
    Ap = A - lw                             # ... up to t - 1
    AL = A[:, :, :, -1:]                    # the whole chunk
    # each chunk's own contribution to the state it hands on
    U = (kc * torch.exp(AL - A)).transpose(-1, -2) @ vc
    decay = torch.exp(AL[:, :, :, 0])       # (B, H, n, K)
    s = (torch.zeros((B, H, K, K), dtype=r.dtype, device=r.device)
         if state0 is None else state0.to(r.dtype))
    entering = []
    for c in range(n):
        entering.append(s)
        s = decay[:, :, c, :, None] * s + U[:, :, c]
    S_in = torch.stack(entering, dim=2)     # (B, H, n, K, K)
    y = (rc * torch.exp(Ap)) @ S_in
    later = torch.tril(torch.ones(L, L, dtype=torch.bool, device=r.device),
                       diagonal=-1)[..., None]       # t > s
    parts = []
    for h0 in range(0, H, head_block):
        hs = slice(h0, h0 + head_block)
        diff = Ap[:, hs, :, :, None, :] - A[:, hs, :, None, :, :]
        dec = torch.exp(torch.where(later, diff, float("-inf")))
        att = torch.sum(rc[:, hs, :, :, None, :] * kc[:, hs, :, None, :, :]
                        * dec, dim=-1)                # (B, h, n, L, L)
        parts.append(att @ vc[:, hs])
    y = y + torch.cat(parts, dim=1)
    y = y + torch.sum(rc * u.to(r.dtype)[None, :, None, None, :] * kc, dim=-1,
                      keepdim=True) * vc
    y = y.permute(0, 2, 3, 1, 4).reshape(B, S + pad, H, K)[:, :S]
    return y, s


def init(c: dict, seed: int, device) -> dict:
    """The weights from ``seed``, as the port lays them out: the layers'
    leaves stacked over the layers."""
    d = Draw(seed, device)
    D, F, R, L = c["d_model"], c["d_ff"], c["lora_rank"], (c["n_layers"],)
    H = D // c["head_dim"]
    W = {"embed": {"e": d.normal((c["vocab"], D), D ** -0.5)}}
    tm = {f"w_{n}": d.dense(D, D, L) for n in "rkvgo"}
    tm.update({f"mu_{n}": d.full(L + (D,), 0.5) for n in "rkvgw"})
    tm["lora_a"] = d.dense(D, R, L)
    tm.update({f"lora_b_{n}": d.dense(R, D, L, scale=0.01) for n in "rkvgw"})
    tm["lora_wa"] = d.dense(D, R, L)
    tm["w0"] = d.full(L + (D,), -1.5)
    tm["u"] = d.full(L + (H, c["head_dim"]), 0.0)
    tm["ln_g"] = d.full(L + (D,), 1.0)
    block = {"n1": d.norm(D, L), "mixer": tm, "n2": d.norm(D, L)}
    block["ffn"] = {"w_k": d.dense(D, F, L), "w_v": d.dense(F, D, L),
                    "w_r": d.dense(D, D, L), "mu_k": d.full(L + (D,), 0.5),
                    "mu_r": d.full(L + (D,), 0.5)}
    W.update(stack=(block,), rem=(), final_norm=d.norm(D))
    if not c["tie_word_embeddings"]:
        W["head"] = d.dense(D, c["vocab"])
    return W


def _layer(p, x, c: dict, prec: Precision):
    """One block, x (B, S, D) f32 -> (B, S, D)."""
    B, S, D = x.shape
    hd = c["head_dim"]
    H = D // hd
    tm, cm = p["mixer"], p["ffn"]
    h = rmsnorm(x, p["n1"]["g"], c["rms_norm_eps"])
    delta = shift(h) - h
    lora = torch.tanh(prec.mm(h, tm["lora_a"]["w"]))

    def mixed(n):
        return h + delta * (tm[f"mu_{n}"] + prec.mm(lora,
                                                    tm[f"lora_b_{n}"]["w"]))

    def heads(t):
        return t.reshape(B, S, H, hd)

    r = heads(prec.mm(mixed("r"), tm["w_r"]["w"]))
    k = heads(prec.mm(mixed("k"), tm["w_k"]["w"]))
    v = heads(prec.mm(mixed("v"), tm["w_v"]["w"]))
    g = F.silu(prec.mm(mixed("g"), tm["w_g"]["w"]))
    xw = torch.tanh(prec.mm(mixed("w"), tm["lora_wa"]["w"]))
    w = heads(torch.exp(-torch.exp(tm["w0"] + prec.mm(xw,
                                                      tm["lora_b_w"]["w"]))))
    y, _ = wkv(prec.operand(r), prec.operand(k), prec.operand(v), w,
               tm["u"])
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + c["group_norm_eps"])
    y = y.reshape(B, S, D) * tm["ln_g"] * g
    x = x + prec.mm(y, tm["w_o"]["w"])

    h = rmsnorm(x, p["n2"]["g"], c["rms_norm_eps"])
    delta = shift(h) - h
    kk = torch.square(torch.relu(prec.mm(h + delta * cm["mu_k"],
                                         cm["w_k"]["w"])))
    rr = torch.sigmoid(prec.mm(h + delta * cm["mu_r"], cm["w_r"]["w"]))
    return x + rr * prec.mm(kk, cm["w_v"]["w"])


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def hidden(W, c: dict, tokens: torch.Tensor,
           prec: Precision = F32) -> torch.Tensor:
    """The final normed hidden states (B, S, D) of token ids (B, S)."""
    x = W["embed"]["e"][tokens.long()].float()
    stack = W["stack"][0]
    remat = torch.is_grad_enabled()
    for i in range(c["n_layers"]):
        fn = lambda x, i=i: _layer(_index(stack, i), x, c, prec)  # noqa: E731
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return rmsnorm(x, W["final_norm"]["g"], c["rms_norm_eps"])


def head(W, c: dict) -> torch.Tensor:
    """(D, V): the head, or the embedding where the two are tied."""
    return W["embed"]["e"].t() if c["tie_word_embeddings"] else W["head"]["w"]


def loss(W, c: dict, batch: dict, prec: Precision = F32) -> torch.Tensor:
    h = hidden(W, c, batch["tokens"], prec)
    return masked_xent(h, head(W, c), batch["labels"], batch["mask"], prec)


def logits_at(W, c: dict, tokens: torch.Tensor, positions: Sequence[int],
              prec: Precision = F32) -> torch.Tensor:
    """(len(positions), V) next-token logits of one sequence (S,)."""
    h = hidden(W, c, tokens[None], prec)[0, list(positions)]
    return prec.mm(h, head(W, c))


def forward_ops(c: dict, seq: int = 0) -> float:
    """A token's forward operations in RWKV-6: the time-mix's five
    d x d projections, the LoRAs, the channel mix, the head, and the
    recurrence's 5 operations a state element, whatever the context
    (``portbench/flops.py``'s conventions)."""
    D, F, V, R = c["d_model"], c["d_ff"], c["vocab"], c["lora_rank"]
    hd = c["head_dim"]
    H = D // hd
    time_mix = 5 * D * D + D * R + 5 * R * D + D * R
    channel_mix = 2 * D * F + D * D
    per_layer = 2 * (time_mix + channel_mix) + 5 * H * hd * hd
    return c["n_layers"] * per_layer + 2 * D * V
