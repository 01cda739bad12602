"""Llama-4 Scout 17B-active / 16 experts.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192(expert) vocab=202048, MoE 16e top-1
with one shared expert per layer (Scout layout).  Text backbone; the "early
fusion" vision path is out of the assigned shape set.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    period=(LayerSpec(mixer="full", ffn="moe"),),
    moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192,
                  n_shared=1, d_ff_shared=8192, capacity_factor=1.25),
    rope_theta=500_000.0,
    # tuned execution defaults (EXPERIMENTS.md §Perf; the paper-faithful
    # baseline is recovered with --override of these knobs)
    attn_remat=True, loss_chunk=1024, moe_ep_serve=True, moe_bf16_dispatch=True,
)
