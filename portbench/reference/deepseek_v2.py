"""Plain PyTorch DeepSeek-V2 (arXiv:2405.04434) in float32.

Imports nothing of the port.  Weights come as a tree laid out as the
port's parameters (``embed``, ``prefix`` the dense first layer,
``stack[0]`` with each leaf stacked over the MoE layers, ``final_norm``,
``head``), the benchmark's inputs, used as given in f32.  Widths are
read from the configuration file's published keys.

- MLA without query compression: q = x W_q split into a nope part and a
  rope part; the latent c = RMSNorm(x W_dkv[:, :r]) and one rope key
  shared by the heads; k_nope = c W_uk, v = c W_uv; causal softmax
  attention at the scale (nope + rope)^-0.5, times YaRN's mscale^2.
- RoPE with YaRN as DeepSeek-V2 defines it, from the file's
  ``rope_scaling`` group (none: plain RoPE): the frequencies blended
  between theta^(-2i/d) and that over ``factor`` by the linear ramp
  between the correction dims of ``beta_fast`` and ``beta_slow``, cos
  and sin times mscale(factor, mscale) / mscale(factor, mscale_all_dim),
  and the softmax scale times mscale(factor, mscale_all_dim)^2, where
  mscale(s, m) = 0.1 m ln s + 1, or 1 where s <= 1.
- The FFN of the first layer is a SiLU GLU; the others are MoE: softmax
  router over the routed experts, the top k by probability (ties to the
  lower expert), no renormalisation (``norm_topk_prob`` false), each
  expert a SiLU GLU, plus the shared experts as one GLU of
  ``n_shared_experts`` x ``moe_intermediate_size``.

Departures, as the configuration file states: YaRN at factor 1, which
is plain RoPE (the rope dims rotate as split halves, the port's layout);
no auxiliary balance loss; the GShard capacity of the port: in each batch
row (T tokens) an expert takes at most C = min(ceil(T k / E x 1.25), T)
assignments, counted in the order (expert, token, k), and the rest are
dropped (they add nothing; the shared experts and the residual carry
the token).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Draw, masked_xent, rmsnorm
from .precision import F32, Precision

CAPACITY_FACTOR = 1.25


def init(c: dict, seed: int, device) -> dict:
    """The weights from ``seed``, as the port lays them out: the dense
    first layers as ``prefix``, the MoE layers' leaves stacked."""
    d = Draw(seed, device)
    D, H, V = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    R, E, Fe = (c["kv_lora_rank"], c["n_routed_experts"],
                c["moe_intermediate_size"])
    n_dense = c["first_k_dense_replace"]
    if n_dense != 1:
        raise ValueError("the port's layout holds one dense first layer")
    L = (c["num_hidden_layers"] - n_dense,)

    def mla(lead):
        return {"q": d.dense(D, H * (dn + dr), lead),
                "dkv": d.dense(D, R + dr, lead), "kv_norm": d.norm(R, lead),
                "uk": d.dense(R, H * dn, lead), "uv": d.dense(R, H * dv, lead),
                "o": d.dense(H * dv, D, lead)}

    W = {"embed": {"e": d.normal((V, D), D ** -0.5)}}
    Fd = c["intermediate_size"]
    W["prefix"] = {"n1": d.norm(D), "mixer": mla(()), "n2": d.norm(D),
                   "ffn": {"up": d.dense(D, Fd), "down": d.dense(Fd, D),
                           "gate": d.dense(D, Fd)}}
    block = {"n1": d.norm(D, L), "mixer": mla(L), "n2": d.norm(D, L)}
    moe = {"router": d.dense(D, E, L, dtype=torch.float32),
           "w_up": d.normal(L + (E, D, Fe), D ** -0.5),
           "w_gate": d.normal(L + (E, D, Fe), D ** -0.5),
           "w_down": d.normal(L + (E, Fe, D), Fe ** -0.5)}
    fs = Fe * c["n_shared_experts"]
    if fs:
        moe.update(sh_up=d.dense(D, fs, L), sh_gate=d.dense(D, fs, L),
                   sh_down=d.dense(fs, D, L))
    block["ffn"] = moe
    W.update(stack=(block,), rem=(), final_norm=d.norm(D),
             head=d.dense(D, V))
    return W


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, d: int, theta: float,
                    max_pos: int) -> float:
    return (d * math.log(max_pos / (rotations * 2 * math.pi))
            / (2 * math.log(theta)))


def rope_freqs(c: dict) -> tuple[torch.Tensor, float]:
    """The rope dims' angular frequencies (float64, on the host) and the
    factor on cos and sin, from ``rope_theta`` and ``rope_scaling``."""
    d, theta = c["qk_rope_head_dim"], c["rope_theta"]
    half = d // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    rs = c.get("rope_scaling")
    if rs is None:
        return freq, 1.0
    if rs["type"] != "yarn":
        raise ValueError(f"rope_scaling type {rs['type']!r}")
    s, max_pos = rs["factor"], rs["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rs["beta_fast"], d, theta,
                                         max_pos)), 0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], d, theta,
                                         max_pos)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp              # 1: the frequency as it is (extrapolated)
    freq = freq / s * (1 - keep) + freq * keep
    return freq, (yarn_mscale(s, rs["mscale"])
                  / yarn_mscale(s, rs["mscale_all_dim"]))


def softmax_scale(c: dict) -> float:
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    rs = c.get("rope_scaling")
    if rs is not None and rs.get("mscale_all_dim"):
        scale *= yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def rope(x: torch.Tensor, c: dict) -> torch.Tensor:
    """x (B, S, H, d): rotary embedding at positions 0.., split halves."""
    S, half = x.shape[1], x.shape[-1] // 2
    freq, mscale = rope_freqs(c)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * freq
    cos = (torch.cos(ang) * mscale).to(x.device, x.dtype)[None, :, None]
    sin = (torch.sin(ang) * mscale).to(x.device, x.dtype)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def glu(x, gate, up, down, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, gate)) * prec.mm(x, up), down)


def mla(p, x, c: dict, prec: Precision):
    B, S, D = x.shape
    H = c["num_attention_heads"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    R = c["kv_lora_rank"]
    q = prec.mm(x, p["q"]["w"]).reshape(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], c)], -1)
    ckr = prec.mm(x, p["dkv"]["w"])
    lat = rmsnorm(ckr[..., :R], p["kv_norm"]["g"], c["rms_norm_eps"])
    kr = rope(ckr[..., None, R:], c)                    # (B, S, 1, dr)
    kn = prec.mm(lat, p["uk"]["w"]).reshape(B, S, H, dn)
    v = prec.mm(lat, p["uv"]["w"]).reshape(B, S, H, dv)
    k = torch.cat([kn, kr.expand(B, S, H, dr)], -1)
    scores = torch.einsum("bshd,bthd->bhst", prec.operand(q),
                          prec.operand(k)) * softmax_scale(c)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("bhst,bthd->bshd", prec.operand(att), prec.operand(v))
    return prec.mm(o.reshape(B, S, H * dv), p["o"]["w"])


def capacity(c: dict, T: int) -> int:
    k, E = c["num_experts_per_tok"], c["n_routed_experts"]
    return max(1, min(int(math.ceil(T * k / E * CAPACITY_FACTOR)), T))


def moe(p, x, c: dict, prec: Precision):
    """x (B, S, D): each batch row routed alone."""
    B, S, D = x.shape
    E, K = c["n_routed_experts"], c["num_experts_per_tok"]
    C = capacity(c, S)
    out = []
    for b in range(B):
        xt = x[b]                                             # (T, D)
        probs = torch.softmax(prec.mm(xt, p["router"]["w"]), -1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_e = top_p[:, :K], top_e[:, :K]
        flat = top_e.reshape(-1)                              # t * K + k
        order = torch.argsort(flat, stable=True)              # by expert
        se = flat[order]
        first = torch.searchsorted(se, torch.arange(E, device=x.device))
        pos = torch.arange(S * K, device=x.device) - first[se]
        keep = pos < C
        tok = order[keep] // K
        ex, slot = se[keep], pos[keep]
        buf = xt.new_zeros((E, C, D))
        buf[ex, slot] = xt[tok]
        h = F.silu(torch.bmm(prec.operand(buf), prec.operand(p["w_gate"]))) \
            * torch.bmm(prec.operand(buf), prec.operand(p["w_up"]))
        y = torch.bmm(prec.operand(h), prec.operand(p["w_down"]))
        wgt = top_p.reshape(-1)[order[keep]]
        out.append(torch.zeros_like(xt).index_add(0, tok,
                                                  y[ex, slot] * wgt[:, None]))
    routed = torch.stack(out)
    return routed + glu(x, p["sh_gate"]["w"], p["sh_up"]["w"],
                        p["sh_down"]["w"], prec)


def _block(p, x, c: dict, prec: Precision, dense: bool):
    x = x + mla(p["mixer"], rmsnorm(x, p["n1"]["g"], c["rms_norm_eps"]),
                c, prec)
    h = rmsnorm(x, p["n2"]["g"], c["rms_norm_eps"])
    f = p["ffn"]
    if dense:
        return x + glu(h, f["gate"]["w"], f["up"]["w"], f["down"]["w"], prec)
    return x + moe(f, h, c, prec)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def hidden(W, c: dict, tokens: torch.Tensor,
           prec: Precision = F32) -> torch.Tensor:
    """The final normed hidden states (B, S, D) of token ids (B, S)."""
    if c["first_k_dense_replace"] != 1 or c["moe_layer_freq"] != 1:
        raise ValueError("one dense layer, then MoE layers, is all this "
                         "reference builds")
    x = W["embed"]["e"][tokens.long()].float()
    remat = torch.is_grad_enabled()
    layers = [(W["prefix"], True)] + [
        (_index(W["stack"][0], i), False)
        for i in range(c["num_hidden_layers"] - 1)]
    for p, dense in layers:
        fn = lambda x, p=p, d=dense: _block(p, x, c, prec, d)  # noqa: E731
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return rmsnorm(x, W["final_norm"]["g"], c["rms_norm_eps"])


def head(W) -> torch.Tensor:
    return W["head"]["w"]


def loss(W, c: dict, batch: dict, prec: Precision = F32) -> torch.Tensor:
    h = hidden(W, c, batch["tokens"], prec)
    return masked_xent(h, head(W), batch["labels"], batch["mask"], prec)


def logits_at(W, c: dict, tokens: torch.Tensor, positions: Sequence[int],
              prec: Precision = F32) -> torch.Tensor:
    h = hidden(W, c, tokens[None], prec)[0, list(positions)]
    return prec.mm(h, head(W))


def _mla_weights(c: dict) -> int:
    D, H = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    R = c["kv_lora_rank"]
    return (D * H * (dn + dr) + D * (R + dr) + R * H * dn + R * H * dv
            + H * dv * D)


def forward_ops(c: dict, seq: int) -> float:
    """A token's forward operations in DeepSeek-V2 at context ``seq``
    (causal: a token attends (seq + 1) / 2 positions on average;
    ``portbench/flops.py``'s conventions)."""
    D, H, V = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    dq = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    dv = c["v_head_dim"]
    n_dense = c["first_k_dense_replace"]
    n_moe = c["num_hidden_layers"] - n_dense
    experts = c["num_experts_per_tok"] + c["n_shared_experts"]
    mla = 2 * _mla_weights(c) + 2 * H * (dq + dv) * (seq + 1) / 2
    dense_ffn = 2 * 3 * D * c["intermediate_size"]
    moe_ffn = (2 * D * c["n_routed_experts"]
               + 2 * 3 * D * c["moe_intermediate_size"] * experts)
    return (n_dense * (mla + dense_ffn) + n_moe * (mla + moe_ffn)
            + 2 * D * V)
