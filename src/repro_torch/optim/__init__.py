"""The optimizer of the port (``repro.optim``' twin): AdamW with global-norm
clipping, and the int8 gradient quantizer with error feedback."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .compress import compress_grads_int8, decompress_grads_int8

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "compress_grads_int8", "decompress_grads_int8"]
