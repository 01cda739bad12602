"""The decoder model stack of the port (``repro.models``' twin): the dense
and the recurrent families."""
from . import recurrent
from .config import ArchConfig, LayerSpec, MLAConfig, MoEConfig, reduced
from .transformer import count_params, init_cache, model_apply, model_init
from .lm import lm_loss, loss_fn, make_decode_step, make_prefill

__all__ = [
    "ArchConfig", "LayerSpec", "MLAConfig", "MoEConfig", "reduced",
    "recurrent",
    "count_params", "init_cache", "model_apply", "model_init",
    "lm_loss", "loss_fn", "make_decode_step", "make_prefill",
]
