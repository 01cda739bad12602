"""RecurrentGemma-2B (Griffin). [arXiv:2402.19427; hf]
26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 — RG-LRU : local-attn at 2:1
(period rec,rec,attn), window 2048, d_rnn=2560, conv width 4.
Sub-quadratic: runs long_500k.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    period=(LayerSpec(mixer="rglru", ffn="glu"),
            LayerSpec(mixer="rglru", ffn="glu"),
            LayerSpec(mixer="local", ffn="glu", window=2048)),
    d_rnn=2560,
    conv_width=4,
    ffn_act="gelu",
    scale_embed=True,
    tie_embeddings=True,
    # tuned execution defaults (EXPERIMENTS.md §Perf; the paper-faithful
    # baseline is recovered with --override of these knobs)
    pure_dp=True, attn_remat=True, loss_chunk=1024,
)
