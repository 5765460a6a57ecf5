"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=32064, dtype=torch.bfloat16,
)


def reduced():
    return TransformerConfig(
        name="phi3-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, dtype=torch.float32, chunk_q=16,
    )


ARCH = ArchSpec(
    id="phi3-mini-3.8b", family="lm", config=CONFIG, shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch: 500k-context decode "
           "requires sub-quadratic attention state (assignment spec)."},
    reduced=reduced,
)
