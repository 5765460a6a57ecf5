"""Synthetic user-item interaction datasets shaped like the paper's §5.2
evaluation (MovieLens / Last.FM / Jester are unavailable offline): the
torch port's own numpy copy of ``repro.data.interactions``, drawing from
the generator in the same order, so one seed gives the same arrays.

Generation model: items live in ``n_clusters`` latent taste clusters;
users have mixed cluster affinities; interactions are sampled by
affinity.  This reproduces the structural properties the paper's
protocol depends on: clustered item-item similarity (so diversification
has something to trade off) and per-user relevance concentration.

The evaluation protocol mirrors §5.2.1:
  * leave-one-out split (one held-out test item per user);
  * item-item cosine similarity from co-occurrence (SUGGEST-style
    item-based CF);
  * per-user candidate set = top-K similar items of profile items;
  * relevance = aggregated similarity to the profile (as in [14]).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class InteractionDataset:
    name: str
    n_users: int
    n_items: int
    train: List[np.ndarray]  # per-user profile item ids
    test: np.ndarray  # (U,) held-out item per user


def synth_interactions(
    name: str,
    n_users: int,
    n_items: int,
    n_clusters: int,
    items_per_user: Tuple[int, int],
    seed: int = 0,
) -> InteractionDataset:
    rng = np.random.default_rng(seed)
    item_cluster_aff = rng.dirichlet(np.full(n_clusters, 0.2), size=n_items)
    user_aff = rng.dirichlet(np.full(n_clusters, 0.3), size=n_users)
    item_pop = rng.zipf(1.3, size=n_items).astype(np.float64)
    item_pop /= item_pop.sum()

    train, test = [], np.zeros(n_users, np.int64)
    for u in range(n_users):
        k = int(rng.integers(items_per_user[0], items_per_user[1] + 1))
        w = (item_cluster_aff @ user_aff[u]) * item_pop
        w /= w.sum()
        items = rng.choice(n_items, size=min(k, n_items), replace=False, p=w)
        test[u] = items[-1]
        train.append(np.sort(items[:-1]))
    return InteractionDataset(name, n_users, n_items, train, test)


def item_similarity(ds: InteractionDataset, shrink: float = 10.0) -> np.ndarray:
    """SUGGEST-style item-based CF similarity: cosine over the user-item
    co-occurrence matrix with a shrinkage prior (dense — M is small)."""
    M = ds.n_items
    X = np.zeros((ds.n_users, M), np.float32)
    for u, items in enumerate(ds.train):
        X[u, items] = 1.0
    co = X.T @ X  # (M, M) co-occurrence
    norms = np.sqrt(np.diag(co))
    denom = norms[:, None] * norms[None, :] + shrink
    S = co / np.maximum(denom, 1e-9)
    np.fill_diagonal(S, 1.0)
    return S.astype(np.float32)


def candidates_and_relevance(
    ds: InteractionDataset, S: np.ndarray, top_k_similar: int
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Per user: candidate ids + relevance (aggregated similarity to the
    profile, as in [14]); candidates = union of top-K similar items of
    each profile item, minus the profile."""
    out = {}
    for u, profile in enumerate(ds.train):
        if profile.size == 0:
            out[u] = (np.zeros(0, np.int64), np.zeros(0, np.float32))
            continue
        sims = S[profile]  # (P, M)
        cand = set()
        for row in sims:
            cand.update(np.argpartition(-row, top_k_similar)[:top_k_similar].tolist())
        cand -= set(profile.tolist())
        cand = np.array(sorted(cand), np.int64)
        rel = S[np.ix_(profile, cand)].sum(axis=0).astype(np.float32)
        out[u] = (cand, rel)
    return out


PRESETS = {
    # scaled-down stand-ins for the paper's three datasets
    "movielens-like": dict(n_users=300, n_items=400, n_clusters=18, items_per_user=(20, 60)),
    "lastfm-like": dict(n_users=200, n_items=320, n_clusters=24, items_per_user=(15, 40)),
    "jester-like": dict(n_users=400, n_items=140, n_clusters=8, items_per_user=(20, 60)),
}


def load_preset(name: str, seed: int = 0) -> InteractionDataset:
    return synth_interactions(name, seed=seed, **PRESETS[name])
