"""Models (the torch counterpart of ``repro.models``): the recsys family
(DeepFM, xDeepFM, Wide&Deep, AutoInt) for serving and training, its fused
EmbeddingBag, the LM family (``transformer``, ``moe``, over the LM
layers of ``layers``), the GraphCast-style GNN (``gnn``), and the
converters of ``repro``'s parameter trees (``convert``), whole or as a
rank's blocks on a mesh.
"""
from repro_torch.models import gnn, moe, transformer
from repro_torch.models.convert import (
    gnn_from_jax,
    params_from_jax,
    place_on_mesh,
    transformer_from_jax,
)
from repro_torch.models.recsys import (
    RecsysConfig,
    RecsysModel,
    bce_loss,
    forward_logits,
    init_params,
    item_embeddings,
    serve_scores,
)

__all__ = [
    "RecsysConfig",
    "RecsysModel",
    "bce_loss",
    "forward_logits",
    "gnn",
    "gnn_from_jax",
    "init_params",
    "item_embeddings",
    "moe",
    "params_from_jax",
    "place_on_mesh",
    "serve_scores",
    "transformer",
    "transformer_from_jax",
]
