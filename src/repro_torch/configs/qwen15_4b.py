"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen1.5-4b", n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936, qkv_bias=True, dtype=torch.bfloat16,
)


def reduced():
    return TransformerConfig(
        name="qwen-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=256, qkv_bias=True, dtype=torch.float32, chunk_q=16,
    )


ARCH = ArchSpec(
    id="qwen1.5-4b", family="lm", config=CONFIG, shapes=LM_SHAPES,
    skips={"long_500k": "pure full-attention arch: 500k-context decode "
           "requires sub-quadratic attention state (assignment spec)."},
    reduced=reduced,
)
