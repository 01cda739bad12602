"""Llama-3.2-11B-Vision (text backbone + cross-attn image layers).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; cross-attention
to image patch embeddings every 5th layer (8 cross layers).  The vision
tower is a STUB: input_specs() supplies pre-projected patch embeddings
(B, 1601, d_model).
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab=128_256,
    period=(LayerSpec(), LayerSpec(), LayerSpec(),
            LayerSpec(cross_attn=True), LayerSpec()),
    n_img_tokens=1601,
    rope_theta=500_000.0,
    # tuned execution defaults (EXPERIMENTS.md §Perf; the paper-faithful
    # baseline is recovered with --override of these knobs)
    attn_remat=True, loss_chunk=1024,
)
