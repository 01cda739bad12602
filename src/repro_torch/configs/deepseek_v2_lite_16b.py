"""DeepSeek-V2-Lite 16B (2.4B active). [arXiv:2405.04434; hf]
27L d_model=2048 16H MLA(kv_lora=512, rope 64, nope 128, v 128)
d_ff=1408 per expert, 64 routed top-6 + 2 shared; first layer dense GLU
(d_ff 10944).  router_norm_topk per the paper.
"""
from repro_torch.models.config import (ArchConfig, LayerSpec, MLAConfig,
                                       MoEConfig)

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,          # nope 128 + rope 64 (q/k); v_head_dim = 128
    d_ff=1408,
    vocab=102_400,
    period=(LayerSpec(mixer="mla", ffn="moe"),),
    first_layer_ffn=10_944,
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128, q_lora_rank=0),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408,
                  n_shared=2, d_ff_shared=1408, capacity_factor=1.25,
                  router_norm_topk=True),
    rope_theta=10_000.0,
    # tuned execution defaults (EXPERIMENTS.md §Perf; the paper-faithful
    # baseline is recovered with --override of these knobs)
    attn_remat=True, loss_chunk=1024, seq_shard=False, moe_group_by_batch=True,
)
