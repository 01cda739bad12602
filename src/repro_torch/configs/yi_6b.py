"""Yi-6B. [arXiv:2403.04652; hf]
32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 — llama arch.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    vocab=64_000,
    period=(LayerSpec(mixer="full", ffn="glu"),),
    rope_theta=5_000_000.0,
    # tuned execution defaults (EXPERIMENTS.md §Perf; the paper-faithful
    # baseline is recovered with --override of these knobs)
    attn_remat=True, loss_chunk=1024,
)
