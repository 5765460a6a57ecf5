"""Stable bucket positions, shared by the two dispatches that fill
fixed-capacity buckets: the MoE layer's (tokens to experts) and the
all-to-all embedding bag's (ids to the ranks that own their rows)."""
from __future__ import annotations

import torch


def dispatch_positions(bucket: torch.Tensor, n_buckets: int,
                       cap: int) -> torch.Tensor:
    """Each entry's position within its bucket, in the stable order of
    the flat bucket ids; ``cap`` where dropped (position ``cap`` or
    later).  ``bucket`` of any shape, ids in ``[0, n_buckets)`` ->
    (bucket.numel(),).  The counts are a sum into ``n_buckets`` slots
    (``bincount``'s length would depend on the ids, which a fake tensor
    does not hold)."""
    flat = bucket.reshape(-1)
    n = flat.numel()
    sort_idx = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_buckets, dtype=flat.dtype,
                         device=flat.device).index_add_(
                             0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos_sorted = torch.arange(n, device=flat.device) - starts[flat[sort_idx]]
    pos = torch.empty_like(pos_sorted).scatter_(0, sort_idx, pos_sorted)
    return torch.clamp_max(pos, cap)
