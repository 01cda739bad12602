"""The model stack of the port (``repro.models``' twin): every family of
the reference's ten configs — dense, MoE, MLA, cross-attention, audio
frontend, recurrent."""
from . import mla, moe, recurrent
from .config import ArchConfig, LayerSpec, MLAConfig, MoEConfig, reduced
from .transformer import (ShardCtx, cache_specs, count_params, init_cache,
                          model_apply, model_init)
from .lm import lm_loss, loss_fn, make_decode_step, make_prefill

__all__ = [
    "ArchConfig", "LayerSpec", "MLAConfig", "MoEConfig", "reduced",
    "mla", "moe", "recurrent",
    "ShardCtx", "cache_specs", "count_params", "init_cache",
    "model_apply", "model_init",
    "lm_loss", "loss_fn", "make_decode_step", "make_prefill",
]
