"""deepfm [recsys]: n_sparse=39 embed_dim=10 mlp=400-400-400
interaction=fm.  [arXiv:1703.04247; paper]"""
import torch

from repro_torch.configs.base import ArchSpec, make_recsys_vocabs
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="deepfm", vocab_sizes=make_recsys_vocabs(39, seed=104),
    embed_dim=10, interaction="fm", mlp_dims=(400, 400, 400),
    dtype=torch.float32,
)


def reduced():
    return RecsysConfig(
        name="deepfm-reduced", vocab_sizes=(50, 30, 80, 20), embed_dim=8,
        interaction="fm", mlp_dims=(32, 16), dtype=torch.float32,
    )


ARCH = ArchSpec(
    id="deepfm", family="recsys", config=CONFIG, shapes=RECSYS_SHAPES,
    skips={}, reduced=reduced,
)
