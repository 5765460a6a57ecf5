"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding-window hybrid, 128k-class context.
[hf:google/gemma-3-1b-pt; unverified]

Adaptation notes: head_dim derived as d_model//n_heads=168
(the HF release uses 128 with a separate head width; the assignment
config pins d_model/heads, so we derive).  Local window = 1024 tokens,
every 6th layer global — the published 5:1 pattern.  long_500k runs for
this arch: 52/62 layers hold only a 1024-slot ring cache."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144, window=1024, global_every=6,
    dtype=torch.bfloat16,
)


def reduced():
    return TransformerConfig(
        name="gemma3-reduced", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, window=8, global_every=3,
        dtype=torch.float32, chunk_q=16,
    )


ARCH = ArchSpec(
    id="gemma3-27b", family="lm", config=CONFIG, shapes=LM_SHAPES,
    skips={},  # hybrid local:global -> long_500k runs (ring caches)
    reduced=reduced,
)
