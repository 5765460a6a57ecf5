"""Assigned input-shape sets, one per architecture family (the torch
counterpart of ``repro.configs.shapes``; every (arch x shape) pair is a
cell)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | graph_train
    # LM
    seq_len: int = 0
    global_batch: int = 0
    # recsys
    batch: int = 0
    n_candidates: int = 0
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple = ()
    n_graphs: int = 0
    nodes_per_graph: int = 0
    edges_per_graph: int = 0


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768,
                             global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768,
                            global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288,
                           global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "graph_train", n_nodes=2708, n_edges=10556,
        d_feat=1433,
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "graph_train", n_nodes=232965, n_edges=114615892,
        d_feat=602, batch_nodes=1024, fanout=(15, 10),
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "graph_train", n_nodes=2449029, n_edges=61859140,
        d_feat=100,
    ),
    "molecule": ShapeSpec(
        "molecule", "graph_train", n_graphs=128, nodes_per_graph=30,
        edges_per_graph=64, d_feat=64,
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "serve", batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", batch=262144),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000
    ),
}
