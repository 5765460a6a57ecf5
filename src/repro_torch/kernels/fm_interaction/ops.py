"""Public dispatch of the FM interaction kernel (K8).

Unlike ``repro``'s wrapper, nothing is padded: the kernel takes the
ragged last tile of examples itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fm_interaction.fm_interaction import (
    fm_interaction_kernel,
)
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref


def fm_interaction(emb: torch.Tensor, block_b: int = 128,
                   force_ref: bool = False) -> torch.Tensor:
    """emb (B, F, D) -> (B,) float32 fused FM second-order term.

    Differentiable: on the card the gradient comes from K8's hand-written
    backward.  ``force_ref`` runs the plain PyTorch oracle (``repro``'s
    ``force_jnp``), differentiated by autograd."""
    if force_ref:
        return fm_interaction_ref(emb)
    return fm_interaction_kernel(emb, block_b=block_b)
