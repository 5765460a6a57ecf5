"""Models (the torch counterpart of ``repro.models``): the recsys family
(DeepFM, xDeepFM, Wide&Deep, AutoInt) for serving, its fused
EmbeddingBag and the converter of ``repro``'s parameter trees.  The LM
and GNN families wait for ROADMAP queue 1 item 12.
"""
from repro_torch.models.convert import params_from_jax
from repro_torch.models.recsys import (
    RecsysConfig,
    RecsysModel,
    forward_logits,
    init_params,
    item_embeddings,
    serve_scores,
)

__all__ = [
    "RecsysConfig",
    "RecsysModel",
    "forward_logits",
    "init_params",
    "item_embeddings",
    "params_from_jax",
    "serve_scores",
]
