"""GraphCast-style encoder-processor-decoder GNN (arXiv:2212.12794), the
torch counterpart of ``repro.models.gnn``.

Message passing over an edge-index array, by scatter (``index_add_``,
``scatter_reduce``) as ``repro`` does it with ``jax.ops.segment_*``:

  encoder:    node MLP  d_feat -> d_hidden
  processor:  n_layers rounds of
                 e'_ij = e_ij + MLP_e([h_i, h_j, e_ij])   (per edge)
                 m_i   = segment_agg_{j->i} e'_ij          (scatter)
                 h'_i  = h_i + MLP_n([h_i, m_i])           (residual)
  decoder:    node MLP  d_hidden -> n_vars

Where gradients are recorded, each processor round runs through
``layers.remat`` (``repro`` checkpoints its scan body): a backward pass
keeps each round's ``h`` and ``e`` and recomputes the round's MLPs and
aggregate one round at a time.

One ``apply`` serves full graphs, padded sampled subgraphs
(``edge_mask``) and batched small molecules (disjoint unions).  The
MLPs' GELU is the tanh approximation, ``jax.nn.gelu``'s default.  Under
``max`` a node with no in-edge aggregates ``-inf``, as
``jax.ops.segment_max`` fills an empty segment; the node MLP then gives
that node non-finite outputs, in ``repro`` and here alike (ROADMAP queue
3).  ``mse_loss`` is the training objective
(``repro_torch.launch.train``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.context import (
    constrain,
    grad_placements,
    is_dtensor,
)
from repro_torch.models import layers
from repro_torch.models.layers import dense


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 16
    d_hidden: int = 512
    d_feat: int = 128
    n_vars: int = 227  # output channels (GraphCast: surface+pressure vars)
    d_edge: int = 16
    aggregator: str = "sum"  # sum | mean | max
    mesh_refinement: int = 6  # recorded from the paper config
    dtype: Any = torch.bfloat16

    def param_count(self) -> int:
        h = self.d_hidden
        enc = self.d_feat * h + h * h
        edge_mlp = (2 * h + self.d_edge) * h + h * self.d_edge
        node_mlp = (h + self.d_edge) * h + h * h
        dec = h * h + h * self.n_vars
        return enc + self.n_layers * (edge_mlp + node_mlp) + dec


class MLP2(nn.Module):
    """``repro``'s ``_mlp2_init``: ``l1`` (d_in -> d_mid) and ``l2``
    (d_mid -> d_out), both biased."""

    def __init__(self, d_in: int, d_mid: int, d_out: int, **kw):
        super().__init__()
        self.l1 = dense(d_in, d_mid, bias=True, **kw)
        self.l2 = dense(d_mid, d_out, bias=True, **kw)


def _mlp2(p: MLP2, x: torch.Tensor) -> torch.Tensor:
    return p.l2(F.gelu(p.l1(x), approximate="tanh"))


class ProcLayer(nn.Module):
    """One processor round's ``edge`` and ``node`` MLPs."""

    def __init__(self, cfg: GNNConfig, **kw):
        super().__init__()
        h, de = cfg.d_hidden, cfg.d_edge
        self.edge = MLP2(2 * h + de, h, de, **kw)
        self.node = MLP2(h + de, h, h, **kw)


class GNN(nn.Module):
    """The parameters of one ``GNNConfig`` (``repro``'s ``init_params``
    tree as modules: ``encoder``, ``edge_embed``, ``processor[i]``,
    ``decoder``), on ``device`` (default the card) or, with
    ``generator``, drawn on the generator's device from ``repro``'s
    distributions."""

    def __init__(self, cfg: GNNConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(generator.device if generator is not None
                             else device)
        kw = dict(generator=generator, device=dev, dtype=cfg.dtype)
        h = cfg.d_hidden
        self.encoder = MLP2(cfg.d_feat, h, h, **kw)
        self.edge_embed = dense(2 * h, cfg.d_edge, bias=True, **kw)
        self.processor = nn.ModuleList(
            [ProcLayer(cfg, **kw) for _ in range(cfg.n_layers)])
        self.decoder = MLP2(h, h, cfg.n_vars, **kw)


def init_params(generator: torch.Generator, cfg: GNNConfig) -> GNN:
    """``repro``'s ``init_params(rng, cfg)``: a ``GNN`` drawn from
    ``generator`` on its device."""
    return GNN(cfg, generator=generator)


def _aggregate(msgs: torch.Tensor, dst: torch.Tensor, n_nodes: int,
               how: str) -> torch.Tensor:
    """Per-node aggregate of the messages into ``dst`` (int64)."""
    if how in ("sum", "mean"):
        s = msgs.new_zeros((n_nodes, msgs.shape[1])).index_add_(0, dst, msgs)
        if how == "sum":
            return s
        cnt = msgs.new_zeros((n_nodes,)).index_add_(
            0, dst, msgs.new_ones(dst.shape))
        return s / torch.clamp_min(cnt, 1.0)[:, None]
    if how == "max":  # an empty segment stays -inf, as segment_max fills it
        out = msgs.new_full((n_nodes, msgs.shape[1]), float("-inf"))
        return out.scatter_reduce(0, dst[:, None].expand_as(msgs), msgs,
                                  "amax", include_self=True)
    raise ValueError(how)


def _endpoints(h: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor) -> torch.Tensor:
    """``[h[src], h[dst]]`` (E, 2 d).  On DTensors (h over the nodes, the
    edges over theirs) under ``local_map``: every rank gathers ``h``
    whole once and reads its edges' endpoints; ``h``'s gradient is each
    rank's share, summed onto its nodes (a reduce-scatter)."""
    if not is_dtensor(h):
        return torch.cat([h[src], h[dst]], dim=-1)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    dm = h.device_mesh
    rep = [Replicate()] * dm.ndim
    e_pl = list(src.placements)
    return local_map(lambda hl, s, d: torch.cat([hl[s], hl[d]], dim=-1),
                     out_placements=e_pl, in_placements=(rep, e_pl, e_pl),
                     in_grad_placements=(grad_placements(rep, e_pl), e_pl,
                                         e_pl),
                     device_mesh=dm, redistribute_inputs=True)(h, src, dst)


def _aggregate_split(msgs: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                     nodes) -> torch.Tensor:
    """The sum aggregate of DTensor messages split over the edges, placed
    on the nodes as ``nodes`` (placements): each rank's edges scattered
    into a whole (N, d) partial sum under ``local_map``, completed onto
    the nodes by a reduce-scatter."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    e_pl = list(dst.placements)
    part = [Partial() if isinstance(p, Shard) else Replicate() for p in e_pl]
    s = local_map(functools.partial(_aggregate, n_nodes=n_nodes, how="sum"),
                  out_placements=part, in_placements=(e_pl, e_pl),
                  device_mesh=msgs.device_mesh,
                  redistribute_inputs=True)(msgs, dst)
    return s.redistribute(msgs.device_mesh, nodes)


def apply(params: GNN, node_feats: torch.Tensor, edges: torch.Tensor,
          cfg: GNNConfig,
          edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """node_feats (N, d_feat), edges (E, 2) [src, dst], edge_mask (E,)
    bool (False: a padding edge) -> per-node predictions (N, n_vars).
    On DTensors (the nodes and the edges each split over the whole
    grid, ``"nodes"`` and ``"edges"``) ``h`` is held on the nodes where
    ``repro`` constrains it; the endpoint reads and the (sum) aggregation
    run under ``local_map`` (:func:`_endpoints`,
    :func:`_aggregate_split`)."""
    N = node_feats.shape[0]
    edges = edges.long()
    src, dst = edges[:, 0], edges[:, 1]
    h = constrain(_mlp2(params.encoder, node_feats.to(cfg.dtype)),
                  "nodes", None)

    # initial edge features from endpoint embeddings
    e = params.edge_embed(_endpoints(h, src, dst))
    mask = None if edge_mask is None else edge_mask[:, None].to(e.dtype)
    if mask is not None:
        e = e * mask

    def aggregate(e, h):
        if not is_dtensor(e):
            return _aggregate(e, dst, N, cfg.aggregator)
        if cfg.aggregator != "sum":  # graphcast's; no cell runs another
            raise NotImplementedError(
                f"aggregator {cfg.aggregator!r} on DTensors: only sum")
        return _aggregate_split(e, dst, N, h.placements)

    def layer(p_l: ProcLayer, h: torch.Tensor, e: torch.Tensor):
        e = e + _mlp2(p_l.edge, torch.cat([_endpoints(h, src, dst), e],
                                          dim=-1))
        if mask is not None:
            e = e * mask
        m = aggregate(e, h)
        h = h + _mlp2(p_l.node, torch.cat([h, m], dim=-1))
        return constrain(h, "nodes", None), e

    for p_l in params.processor:
        h, e = layers.remat(layer, p_l, h, e)
    return _mlp2(params.decoder, h)


def mse_loss(params: GNN, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """batch: node_feats, edges, targets (N, n_vars), node_mask and
    edge_mask optional -> the mean squared error in float32, over the
    masked nodes' ``sum(node_mask) * n_vars`` values where a node mask is
    given."""
    preds = apply(params, batch["node_feats"], batch["edges"], cfg,
                  edge_mask=batch.get("edge_mask")).to(torch.float32)
    err = (preds - batch["targets"].to(torch.float32)) ** 2
    mask = batch.get("node_mask")
    if mask is not None:
        mf = mask.to(torch.float32)[:, None]
        return torch.sum(err * mf) / (torch.sum(mf) * cfg.n_vars)
    return torch.mean(err)
