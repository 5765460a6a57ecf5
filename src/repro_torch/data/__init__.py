"""Synthetic data: the recsys click-log generator
(``repro_torch.data.synthetic``) and the §5.2 interaction datasets with
their evaluation protocol (``repro_torch.data.interactions``)."""
from repro_torch.data.synthetic import recsys_batches
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
    "InteractionDataset",
    "candidates_and_relevance",
    "item_similarity",
    "load_preset",
    "recsys_batches",
    "synth_interactions",
]
