"""xdeepfm [recsys]: n_sparse=39 embed_dim=10 cin_layers=200-200-200
mlp=400-400 interaction=cin.  [arXiv:1803.05170; paper]"""
import torch

from repro_torch.configs.base import ArchSpec, make_recsys_vocabs
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="xdeepfm", vocab_sizes=make_recsys_vocabs(39, seed=102),
    embed_dim=10, interaction="cin", cin_layers=(200, 200, 200),
    mlp_dims=(400, 400), dtype=torch.float32,
)


def reduced():
    return RecsysConfig(
        name="xdeepfm-reduced", vocab_sizes=(50, 30, 80, 20), embed_dim=8,
        interaction="cin", cin_layers=(12, 12), mlp_dims=(32, 16),
        dtype=torch.float32,
    )


ARCH = ArchSpec(
    id="xdeepfm", family="recsys", config=CONFIG, shapes=RECSYS_SHAPES,
    skips={}, reduced=reduced,
)
