"""Input-shape sets (the torch counterpart of ``repro.configs.shapes``;
only the recsys family's set is ported, the LM and GNN sets wait for
ROADMAP queue 1 item 12)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | serve | retrieval
    batch: int = 0
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "serve", batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", batch=262144),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000
    ),
}
