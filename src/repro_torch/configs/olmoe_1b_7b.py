"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8.  [arXiv:2409.02060; hf]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024, capacity_factor=1.25),
    dtype=torch.bfloat16,
)


def reduced():
    return TransformerConfig(
        name="olmoe-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=48, vocab=256, moe=MoEConfig(n_experts=8, top_k=4, d_ff=48),
        dtype=torch.float32, chunk_q=16,
    )


ARCH = ArchSpec(
    id="olmoe-1b-7b", family="lm", config=CONFIG, shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch: 500k-context decode "
           "requires sub-quadratic attention state (assignment spec)."},
    reduced=reduced,
)
