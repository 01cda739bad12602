"""RWKV-6 (Finch) 3B. [arXiv:2404.05892; hf]
32L d_model=2560 attention-free (time-mix w/ data-dependent decay,
head dim 64) d_ff=8960 (channel-mix) vocab=65536.  Sub-quadratic: runs
long_500k (state is O(1) in context).
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="rwkv6-3b",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # d_model / rwkv_head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65_536,
    period=(LayerSpec(mixer="rwkv6", ffn="rwkv_cm"),),
    rwkv_head_dim=64,
    # tuned execution defaults (EXPERIMENTS.md §Perf; the paper-faithful
    # baseline is recovered with --override of these knobs)
    pure_dp=True, loss_chunk=1024,
)
