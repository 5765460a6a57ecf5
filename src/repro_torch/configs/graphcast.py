"""graphcast [gnn]: n_layers=16 d_hidden=512 mesh_refinement=6
aggregator=sum n_vars=227 — encoder-processor-decoder mesh GNN.
[arXiv:2212.12794; unverified]

The paper's technique (DPP re-ranking) is inapplicable to the weather
regression objective itself; node embeddings from the decoder are
DPP-diversifiable downstream.  d_feat varies per assigned graph shape
and is taken from the ShapeSpec where a graph of that shape is built."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="graphcast", n_layers=16, d_hidden=512, d_feat=227, n_vars=227,
    d_edge=64, aggregator="sum", mesh_refinement=6, dtype=torch.bfloat16,
)


def reduced():
    return GNNConfig(
        name="graphcast-reduced", n_layers=2, d_hidden=32, d_feat=16,
        n_vars=8, d_edge=8, dtype=torch.float32,
    )


ARCH = ArchSpec(
    id="graphcast", family="gnn", config=CONFIG, shapes=GNN_SHAPES,
    skips={}, reduced=reduced,
)
