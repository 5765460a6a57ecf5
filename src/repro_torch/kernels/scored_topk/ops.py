"""Public dispatch of scored_topk: the block-survivor kernel (K7) and the
final top-c over its survivors.

As in ``repro``, ragged M (not a multiple of the block rows) runs the
kernel, which scores rows past M as -inf by global index; unlike
``repro``, nothing is padded in memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scored_topk.ref import scored_topk_ref
from repro_torch.kernels.scored_topk.scored_topk import scored_topk_blocks


def scored_topk(emb: torch.Tensor, query: torch.Tensor, c: int = 128,
                block_m: int = 8192, force_ref: bool = False):
    """Global top-c of ``emb @ query``: (vals (c,) float32, idx (c,)
    int32), value descending, then lowest index first.

    ``force_ref`` runs the plain PyTorch oracle (``repro``'s
    ``force_jnp``)."""
    M = emb.shape[0]
    if c > M:
        raise ValueError(f"c={c} exceeds the candidate count M={M}")
    if force_ref:
        return scored_topk_ref(emb, query, c)
    bvals, bidx = scored_topk_blocks(emb, query, c, block_m)
    # Each block's survivors come in (value descending, lowest index
    # first) order and the blocks hold increasing index ranges, so among
    # equal values the flattened order is the index order: a stable sort
    # by value alone gives lax.top_k's order exactly.
    vals, pos = torch.sort(bvals.reshape(-1), descending=True, stable=True)
    return vals[:c], bidx.reshape(-1)[pos[:c]]
