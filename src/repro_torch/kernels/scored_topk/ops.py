"""Public dispatch of scored_topk: the global top-c of ``emb @ query`` from
one K7 launch over a single segment of all M rows.

``repro`` runs its block kernel and then a top-c over the ``nb * c``
block survivors; here the kernel's CTAs select across the whole pool
and sort the c winners themselves, so no device op follows the launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scored_topk.ref import scored_topk_ref
from repro_torch.kernels.scored_topk.scored_topk import scored_topk_global


def scored_topk(emb: torch.Tensor, query: torch.Tensor, c: int = 128,
                block_m: int = 8192, force_ref: bool = False):
    """Global top-c of ``emb @ query``: (vals (c,) float32, idx (c,)
    int32), value descending, then lowest index first.

    ``block_m`` is ``repro``'s block size, checked and kept for its
    signature; the one-segment launch does not use it.  ``force_ref``
    runs the plain PyTorch oracle (``repro``'s ``force_jnp``)."""
    M = emb.shape[0]
    if c > M:
        raise ValueError(f"c={c} exceeds the candidate count M={M}")
    if block_m < 1:
        raise ValueError(f"block_m must be >= 1, got {block_m}")
    if force_ref:
        return scored_topk_ref(emb, query, c)
    return scored_topk_global(emb, query, c)
