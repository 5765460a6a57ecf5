"""Sharded candidate-axis DPP rerank: slates over millions of candidates
(the torch counterpart of ``repro/serving/sharded_rerank.py`` and of
``repro/serving/api.py``'s ``_sharded_rerank_impl``).

The same contract as the single-device ``Reranker.rerank``, with the
candidate axis sharded over ``cfg.mesh`` (``Reranker`` routes here when
``cfg.mesh`` is set; every rank of the mesh's group calls it with the
same request and returns the same slate):

* the top-C shortlist is a sharded top-k (``core.sharded.sharded_topk``)
  that yields a selectable mask over the whole candidate axis; features
  are never gathered into a (C, D) shortlist;
* greedy MAP runs through ``core.sharded.greedy_local`` on this rank's
  ``(B, D, M/P)`` column shard of ``V``, built from its own columns only,
  with one all-gather and one all-reduce of a few values a user per
  step; on a CUDA mesh the local update is the shard-local update entry
  of K3/K4 (``cfg.tile_m`` its tile).

``sharded_stream_state`` prepares the same for ``Reranker.stream``: the
rank's resumable ``core.sharded.ShardedState`` over its shard.

Returned ids are global ids into the request's M, the single-device
rerank's slate up to exact float ties between distinct items (see
``repro_torch.core.sharded``).
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_matrix import map_relevance
from repro_torch.core.sharded import (
    ShardedState,
    greedy_local,
    local_columns,
    sharded_topk,
)
from repro_torch.distributed.context import shard_bounds


def _sharded_kernel(scores, feats, cfg, mask, width=None):
    """This rank's shard of the masked shortlist and of the scaled
    features.  scores (B, M); feats (M, D) shared or (B, M, D) per user;
    mask (B, M) bool or None; all on the mesh's device.  Returns
    ``(Vl (B, D, Mloc) float32, selectable mask (B, Mloc), base)``:
    columns ``[base, base + Mloc)`` of the request padded (mask False,
    relevance 0) to ``width >= M`` columns (default M) and split over
    the mesh at that width.  The router passes its bucket, so a column
    has the same owner in every lane; the shortlist is the request's
    own either way."""
    if cfg.mesh is None:
        raise ValueError(
            "the sharded rerank path needs cfg.mesh (see DPPRerankConfig)"
        )
    B, M = scores.shape
    C = min(cfg.shortlist, M)
    if width is not None and width < M:
        raise ValueError(f"a request of {M} candidates does not fit a "
                         f"width of {width}")
    base, Mloc = shard_bounds(M if width is None else width, cfg.mesh)
    selectable = local_columns(
        torch.ones_like(scores, dtype=torch.bool) if mask is None else mask,
        base, Mloc, False)
    if C < M:
        s = scores if mask is None else torch.where(
            mask, scores, torch.finfo(scores.dtype).min
        )
        _, top_i = sharded_topk(s, C, mesh=cfg.mesh,
                                axis_name=cfg.axis_name)
        loc = top_i - base
        inside = (loc >= 0) & (loc < Mloc)
        # one spill column takes the ids of other shards
        short = torch.zeros((B, Mloc + 1), dtype=torch.bool,
                            device=scores.device)
        short.scatter_(1, torch.where(inside, loc, Mloc), True)
        selectable &= short[:, :Mloc]
    rel = map_relevance(local_columns(scores, base, Mloc, 0.0)
                        .to(torch.float32), cfg.alpha)
    # non-selectable items (masked, shortlisted out, padding) never enter
    # the slate, but their relevance still scales columns of V: a NaN or
    # inf there would poison every rank's matvec.  Zero every column the
    # single-device rerank would never build (it gathers the shortlist).
    rel = torch.where(selectable, rel, 0.0)
    f = local_columns(feats.transpose(-1, -2), base, Mloc, 0.0)  # (.., D, Mloc)
    if f.ndim == 2:
        f = f[None]
    Vl = (f.to(torch.float32) * rel[:, None, :]).contiguous()
    return Vl, selectable, base


def sharded_rerank(scores, feats, cfg, mask):
    """A user batch on the mesh: scores (B, M), feats (M, D) or
    (B, M, D), mask (B, M) or None, on the mesh's device.  Returns
    ``(indices (B, k) int32 global ids, -1 after an eps-stop; d_hist
    (B, k))``."""
    Vl, selectable, base = _sharded_kernel(scores, feats, cfg, mask)
    return greedy_local(Vl, selectable, cfg.slate_size, mesh=cfg.mesh,
                        base=base, window=cfg.window, eps=cfg.eps,
                        tile_m=cfg.tile_m)


def sharded_stream_state(scores, feats, cfg, mask):
    """The resumable sharded state of one request on this rank (every
    rank calls it: the shortlist's all-gather pairs them): scores
    ``(1, M)``, feats ``(M, D)``, mask ``(1, M)`` or None, on the mesh's
    device.  Its chunks (``core.streaming.greedy_chunk``) yield global
    ids and concatenate to :func:`sharded_rerank`'s slate."""
    Vl, selectable, base = _sharded_kernel(scores, feats, cfg, mask)
    return ShardedState(Vl, selectable, cfg.slate_size, mesh=cfg.mesh,
                        base=base, M=scores.shape[-1], window=cfg.window,
                        tile_m=cfg.tile_m, single=True)
