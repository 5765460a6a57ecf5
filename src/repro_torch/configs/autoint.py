"""autoint [recsys]: n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32 interaction=self-attn.  [arXiv:1810.11921; paper]"""
import torch

from repro_torch.configs.base import ArchSpec, make_recsys_vocabs
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="autoint", vocab_sizes=make_recsys_vocabs(39, seed=101),
    embed_dim=16, interaction="self-attn", attn_layers=3, attn_heads=2,
    d_attn=32, dtype=torch.float32,
)


def reduced():
    return RecsysConfig(
        name="autoint-reduced", vocab_sizes=(50, 30, 80, 20), embed_dim=8,
        interaction="self-attn", attn_layers=2, attn_heads=2, d_attn=4,
        dtype=torch.float32,
    )


ARCH = ArchSpec(
    id="autoint", family="recsys", config=CONFIG, shapes=RECSYS_SHAPES,
    skips={}, reduced=reduced,
)
