"""Architecture configuration (shared by all 10 assigned archs).

A copy of the reference's ``models/config.py``: plain dataclasses, no
framework.  Configurations of families the port does not build yet load
here all the same; the model code raises on them.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden dim
    n_shared: int = 0
    d_ff_shared: int = 0         # hidden dim of the shared expert(s)
    capacity_factor: float = 1.25
    router_norm_topk: bool = False   # deepseek: renormalize top-k probs


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    q_lora_rank: int = 0         # 0 = no query compression (V2-Lite)


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "full"          # full | local | mla | rglru | rwkv6
    ffn: str = "glu"             # glu | mlp | rwkv_cm | moe
    cross_attn: bool = False     # VLM: cross-attend to image embeddings
    window: int = 0              # local attention window


@dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # repeating layer pattern; layer i uses period[i % len(period)]
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    qkv_bias: bool = False
    attn_softcap: float = 0.0     # gemma2: 50.0
    logit_softcap: float = 0.0    # gemma2: 30.0
    post_norm: bool = False       # gemma2 sandwich norms
    causal: bool = True           # False for encoder-only (hubert)
    encoder_only: bool = False
    ffn_act: str = "silu"         # silu | gelu  (for glu/mlp kinds)
    rope_theta: float = 10_000.0
    attn_scale: float = 0.0       # 0 -> 1/sqrt(head_dim)
    # recurrent families
    d_rnn: int = 0                # rglru width
    conv_width: int = 4           # rglru temporal conv
    rwkv_head_dim: int = 64
    # multimodal stub
    n_img_tokens: int = 0         # >0 -> VLM with precomputed patch embeds
    audio_frontend: bool = False  # hubert: inputs are frame embeddings
    tie_embeddings: bool = True
    scale_embed: bool = False     # gemma family: x *= sqrt(d_model)
    first_layer_ffn: int = 0      # deepseek: layer 0 is a dense GLU of this dim
    # execution knobs (overridable per run / hillclimb)
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    seq_shard: bool = True        # shard residual-stream seq dim on "model"
    use_scan: bool = True
    attention_impl: str = "xla_chunked"   # xla_chunked | naive | pallas
    decode_cache_len: int = 0     # serve_step cache length (set by shape)
    # §Perf hillclimb levers (see EXPERIMENTS.md §Perf)
    loss_chunk: int = 0           # >0: fused seq-chunked xent, no full logits
    attn_remat: bool = False      # checkpoint the blockwise-attention body
    moe_bf16_dispatch: bool = False  # bf16 combine path in the MoE
    serve_fsdp: bool = False      # serve mode: shard weights over data too
    pure_dp: bool = False         # batch over (data×model), no TP — for
    #   archs whose head/vocab dims don't divide the model axis (qwen2)
    moe_group_by_batch: bool = False  # per-row MoE dispatch: sort/route
    #   each batch row locally (per-row capacity) — keeps the token
    #   sort/scatter inside the data shard instead of a global resort
    moe_ep_serve: bool = False    # serve mode: experts over data ×
    #   intra-expert TP over model — weights never move, tokens all-to-all
    moe_fsdp_axis: str = "d"      # expert-weight FSDP dim: "d" (D-sharded,
    #   contraction partials) or "f" (Megatron-style F-sharded up/down)

    # -- derived helpers -----------------------------------------------------
    @property
    def n_prefix(self) -> int:
        return 1 if self.first_layer_ffn else 0

    @property
    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        p = self.period
        return tuple(p[i % len(p)] for i in range(self.n_layers - self.n_prefix))

    @property
    def n_full_periods(self) -> int:
        return (self.n_layers - self.n_prefix) // len(self.period)

    @property
    def n_remainder(self) -> int:
        return (self.n_layers - self.n_prefix) % len(self.period)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer does full attention (long_500k eligibility)."""
        return all(s.mixer in ("local", "rglru", "rwkv6") for s in self.period)

    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test config of the same family: tiny dims, same structure."""
    scale_heads = max(1, cfg.n_heads // 4)
    # keep the GQA group ratio and K | H divisibility
    scale_kv = max(1, scale_heads * cfg.n_kv_heads // cfg.n_heads)
    scale_heads = max(scale_kv, scale_heads // scale_kv * scale_kv)
    moe = None
    if cfg.moe is not None:
        moe = replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
                      top_k=min(cfg.moe.top_k, 2), d_ff=64,
                      d_ff_shared=64 if cfg.moe.n_shared else 0)
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(kv_lora_rank=32, rope_head_dim=16, nope_head_dim=32,
                        v_head_dim=32, q_lora_rank=0)
    period = tuple(replace(s, window=min(s.window, 16) if s.window else 0)
                   for s in cfg.period)
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2 * len(cfg.period)),
        d_model=64,
        n_heads=scale_heads,
        n_kv_heads=scale_kv,
        head_dim=16,
        d_ff=96,
        vocab=128,
        d_rnn=64 if cfg.d_rnn else 0,
        rwkv_head_dim=16,
        moe=moe,
        mla=mla,
        period=period,
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        q_chunk=16,
        kv_chunk=16,
        remat=False,
        seq_shard=False,
    )
