"""Gemma-2 2B. [arXiv:2408.00118; hf]
26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 — alternating
local(4096)/global attention, attn softcap 50, final logit softcap 30,
sandwich (pre+post) RMSNorms, GeGLU, embeddings scaled by sqrt(d).
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256_000,
    period=(LayerSpec(mixer="local", ffn="glu", window=4096),
            LayerSpec(mixer="full", ffn="glu")),
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norm=True,
    ffn_act="gelu",
    scale_embed=True,
    tie_embeddings=True,
    attn_scale=256 ** -0.5,   # query_pre_attn_scalar = 256
    # tuned execution defaults (EXPERIMENTS.md §Perf; the paper-faithful
    # baseline is recovered with --override of these knobs)
    pure_dp=True, attn_remat=True, loss_chunk=1024,
)
