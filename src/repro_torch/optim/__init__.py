"""The optimizer, its LR schedules and gradient compression (the torch
counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import constant_lr, cosine_warmup
from repro_torch.optim.compression import (
    ErrorFeedbackState,
    compress_int8,
    decompress_int8,
    ef_compress_grads,
    ef_init,
)

__all__ = [
    "AdamWConfig",
    "ErrorFeedbackState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "compress_int8",
    "constant_lr",
    "cosine_warmup",
    "decompress_int8",
    "ef_compress_grads",
    "ef_init",
    "global_norm",
]
