"""wide-deep [recsys]: n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat.  [arXiv:1606.07792; paper]"""
import torch

from repro_torch.configs.base import ArchSpec, make_recsys_vocabs
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="wide-deep", vocab_sizes=make_recsys_vocabs(40, seed=103),
    embed_dim=32, interaction="concat", mlp_dims=(1024, 512, 256),
    dtype=torch.float32,
)


def reduced():
    return RecsysConfig(
        name="wide-deep-reduced", vocab_sizes=(50, 30, 80, 20), embed_dim=8,
        interaction="concat", mlp_dims=(32, 16), dtype=torch.float32,
    )


ARCH = ArchSpec(
    id="wide-deep", family="recsys", config=CONFIG, shapes=RECSYS_SHAPES,
    skips={}, reduced=reduced,
)
