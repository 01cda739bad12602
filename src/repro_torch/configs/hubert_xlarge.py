"""HuBERT X-Large. [arXiv:2106.07447; unverified]
48L d_model=1280 16H d_ff=5120 vocab=504 (cluster targets) — encoder-only,
bidirectional, plain GELU MLP.  The conv waveform frontend is a STUB:
input_specs() supplies frame embeddings (B, S, d_model).  No decode shapes.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="hubert-xlarge",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    period=(LayerSpec(mixer="full", ffn="mlp"),),
    causal=False,
    encoder_only=True,
    audio_frontend=True,
    ffn_act="gelu",
    tie_embeddings=False,
    # tuned execution defaults (EXPERIMENTS.md §Perf; the paper-faithful
    # baseline is recovered with --override of these knobs)
    pure_dp=True, attn_remat=True, loss_chunk=504,
)
