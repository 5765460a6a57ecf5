"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff=4864, capacity_factor=1.25),
    moe_dense_residual=True, dtype=torch.bfloat16,
)


def reduced():
    return TransformerConfig(
        name="arctic-reduced", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=96),
        moe_dense_residual=True, dtype=torch.float32, chunk_q=16,
    )


ARCH = ArchSpec(
    id="arctic-480b", family="lm", config=CONFIG, shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch: 500k-context decode "
           "requires sub-quadratic attention state (assignment spec); "
           "no sliding-window/SSM layers to bound the KV cache."},
    reduced=reduced,
)
