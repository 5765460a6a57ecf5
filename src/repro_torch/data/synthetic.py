"""Synthetic data pipelines (the torch counterpart of
``repro.data.synthetic``; numpy only, so both packages draw the same
arrays from the same seed): the LM token stream, the recsys click logs
and the graphs (a random graph, its neighbour sampler and padding, and
batched molecules).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------


def lm_batches(
    vocab: int, batch: int, seq: int, seed: int = 0
) -> Iterator[dict]:
    """Zipf-ish token stream (heavy-tail like natural text)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq), p=probs).astype(np.int32)
        yield {"tokens": toks}


# ---------------------------------------------------------------------------
# RecSys click logs (planted-logit ground truth so training can learn)
# ---------------------------------------------------------------------------


def recsys_batches(
    vocab_sizes: Tuple[int, ...],
    batch: int,
    hot: int = 1,
    seed: int = 0,
    planted_dim: int = 8,
    signal_scale: float = 3.0,
) -> Iterator[dict]:
    """ids (B, F, H) int32 (-1 pad), labels (B,) in {0,1} from a planted
    low-rank logistic model over hashed field embeddings."""
    rng = np.random.default_rng(seed)
    F = len(vocab_sizes)
    # planted per-field hash projections -> a fixed logistic teacher
    planted = [rng.normal(size=(min(v, 64), planted_dim)) * 0.5
               for v in vocab_sizes]
    w = rng.normal(size=(planted_dim,)) * signal_scale
    while True:
        ids = np.stack(
            [rng.integers(0, v, size=(batch, hot)) for v in vocab_sizes],
            axis=1,
        ).astype(np.int32)
        if hot > 1:  # random multi-hot padding to exercise bags
            drop = rng.uniform(size=ids.shape) < 0.3
            drop[:, :, 0] = False
            ids = np.where(drop, -1, ids)
        z = np.zeros((batch,))
        for f in range(F):
            emb = planted[f][ids[:, f, 0] % planted[f].shape[0]]
            z += emb @ w / np.sqrt(F)
        labels = (rng.uniform(size=batch) < 1 / (1 + np.exp(-z))).astype(
            np.float32)
        yield {"ids": ids, "labels": labels}


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Graph:
    node_feats: np.ndarray  # (N, d_feat) f32
    edges: np.ndarray  # (E, 2) int32 [src, dst]
    targets: np.ndarray  # (N, n_vars) f32
    csr_indptr: np.ndarray  # (N+1,) — for neighbor sampling
    csr_indices: np.ndarray  # (E,)


def random_graph(
    n_nodes: int, n_edges: int, d_feat: int, n_vars: int, seed: int = 0
) -> Graph:
    """Random graph with mild degree skew + smooth planted targets."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-ish skew: square a uniform for dst popularity
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    dst = ((rng.uniform(size=n_edges) ** 2) * n_nodes).astype(np.int32)
    edges = np.stack([src, dst], axis=1)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    w = rng.normal(size=(d_feat, n_vars)).astype(np.float32) / np.sqrt(d_feat)
    targets = (feats @ w).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    sorted_dst = dst[order]
    indptr = np.searchsorted(sorted_dst, np.arange(n_nodes + 1)).astype(np.int64)
    return Graph(feats, edges, targets, indptr, src[order].astype(np.int32))


def neighbor_sample(
    g: Graph, batch_nodes: np.ndarray, fanouts: Tuple[int, ...], rng: np.random.Generator
) -> dict:
    """GraphSAGE-style sampled subgraph with fixed fanouts.

    Returns padded arrays (static shapes): node ids (layer-wise frontier),
    remapped edge list, masks.  in-edges are sampled per destination node
    from the CSR structure.
    """
    frontier = batch_nodes.astype(np.int64)
    all_nodes = [frontier]
    all_edges = []
    for fan in fanouts:
        srcs = np.full((frontier.size, fan), -1, np.int64)
        for i, n in enumerate(frontier):
            lo, hi = g.csr_indptr[n], g.csr_indptr[n + 1]
            deg = hi - lo
            if deg == 0:
                continue
            pick = rng.integers(lo, hi, size=fan)
            srcs[i] = g.csr_indices[pick]
        dsts = np.repeat(frontier, fan)
        flat_src = srcs.reshape(-1)
        valid = flat_src >= 0
        all_edges.append(np.stack([flat_src, dsts], axis=1)[valid])
        frontier = np.unique(flat_src[valid])
        all_nodes.append(frontier)

    nodes = np.unique(np.concatenate(all_nodes))
    remap = {int(n): i for i, n in enumerate(nodes)}
    edges = np.concatenate(all_edges) if all_edges else np.zeros((0, 2), np.int64)
    edges = np.array(
        [[remap[int(s)], remap[int(d)]] for s, d in edges], np.int32
    ).reshape(-1, 2)
    seeds_local = np.array([remap[int(n)] for n in batch_nodes], np.int32)
    return {
        "node_ids": nodes.astype(np.int64),
        "node_feats": g.node_feats[nodes],
        "edges": edges,
        "targets": g.targets[nodes],
        "seed_mask_ids": seeds_local,
    }


def pad_subgraph(sub: dict, max_nodes: int, max_edges: int) -> dict:
    """Pad a sampled subgraph to static shapes with masks."""
    n, e = sub["node_feats"].shape[0], sub["edges"].shape[0]
    assert n <= max_nodes and e <= max_edges, (n, e, max_nodes, max_edges)
    node_feats = np.zeros((max_nodes,) + sub["node_feats"].shape[1:], np.float32)
    node_feats[:n] = sub["node_feats"]
    targets = np.zeros((max_nodes,) + sub["targets"].shape[1:], np.float32)
    targets[:n] = sub["targets"]
    edges = np.zeros((max_edges, 2), np.int32)
    edges[:e] = sub["edges"]
    node_mask = np.zeros((max_nodes,), bool)
    node_mask[sub["seed_mask_ids"]] = True  # loss only on seed nodes
    edge_mask = np.zeros((max_edges,), bool)
    edge_mask[:e] = True
    return {
        "node_feats": node_feats,
        "edges": edges,
        "targets": targets,
        "node_mask": node_mask,
        "edge_mask": edge_mask,
    }


def batched_molecules(
    n_graphs: int, nodes_per: int, edges_per: int, d_feat: int, n_vars: int, seed: int = 0
) -> dict:
    """Disjoint union of small graphs (the ``molecule`` shape)."""
    rng = np.random.default_rng(seed)
    feats, edges, targets = [], [], []
    for i in range(n_graphs):
        g = random_graph(nodes_per, edges_per, d_feat, n_vars, seed=seed * 131 + i)
        feats.append(g.node_feats)
        edges.append(g.edges + i * nodes_per)
        targets.append(g.targets)
    return {
        "node_feats": np.concatenate(feats),
        "edges": np.concatenate(edges).astype(np.int32),
        "targets": np.concatenate(targets),
    }
