"""Qwen2-0.5B. [arXiv:2407.10671; hf]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 — QKV bias, tied embed.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151_936,
    period=(LayerSpec(mixer="full", ffn="glu"),),
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    # tuned execution defaults (EXPERIMENTS.md §Perf; the paper-faithful
    # baseline is recovered with --override of these knobs)
    pure_dp=True, attn_remat=True, loss_chunk=1024,
)
