"""Synthetic data: the LM token stream, the recsys click logs and the
graphs (``repro_torch.data.synthetic``), and the §5.2 interaction
datasets with their evaluation protocol
(``repro_torch.data.interactions``)."""
from repro_torch.data.synthetic import (
    Graph,
    batched_molecules,
    lm_batches,
    neighbor_sample,
    pad_subgraph,
    random_graph,
    recsys_batches,
)
from repro_torch.data.interactions import (
    PRESETS,
    InteractionDataset,
    candidates_and_relevance,
    item_similarity,
    load_preset,
    synth_interactions,
)

__all__ = [
    "PRESETS",
    "Graph",
    "InteractionDataset",
    "batched_molecules",
    "candidates_and_relevance",
    "item_similarity",
    "lm_batches",
    "load_preset",
    "neighbor_sample",
    "pad_subgraph",
    "random_graph",
    "recsys_batches",
    "synth_interactions",
]
