"""Paper Figure 3: accuracy-diversity trade-off of Random/Top, MMR,
Greedy [3], and Div-DPP on three synthetic datasets shaped like
MovieLens / Last.FM / Jester (see ``repro_torch.data.interactions`` for
the generation model), using the paper's §5.2 protocol: leave-one-out
split, SUGGEST-style item-item similarity, top-K-similar candidate sets,
aggregated-similarity relevance, recall + average/minimum/median
dissimilarity; the counterpart of ``repro``'s
``benchmarks/fig3_tradeoff.py``.

Each user's problem is solved on the device, user by user as in
``repro``: MMR and greedy-avg as eager torch loops, Div-DPP as the dense
torch core ``dpp_greedy_dense``.  Div-DPP takes no kernel row here: ``S``
is a shrunk co-occurrence cosine, not the Gram matrix of item features,
so there is no low-rank ``V`` with ``L = V^T V`` for the kernels to take.
The random baseline is numpy and shares one generator across its rows,
in ``bs`` order, as ``repro``'s does.  The figure measures quality, not
speed: its ``us_per_call`` column is 0, as in ``repro``.

  python -m repro_torch.figures.fig3_tradeoff [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (
    build_kernel_dense,
    dpp_greedy_dense,
    greedy_avg_select,
    mean_slate_diversity,
    mmr_select,
    random_top_select,
    recall_at_n,
)
from repro_torch.data import candidates_and_relevance, item_similarity, load_preset
from repro_torch.device import resolve_device
from repro_torch.figures.common import device_line, parse

DATASETS = {
    "movielens-like": dict(N=20, K=30),
    "lastfm-like": dict(N=10, K=20),
    "jester-like": dict(N=10, K=20),
}
DPP_EPS = 1e-4


def normalize(rel):
    """Relevance scaled to [0, 1] (numpy float32, as ``repro``'s)."""
    lo, hi = rel.min(), rel.max()
    return (rel - lo) / max(hi - lo, 1e-9)


def eval_algorithm(ds, S, cands, N, select_fn):
    """select_fn(cand_ids, rel) -> local indices into cand_ids (N,).
    Returns (recall, diversity, users (U',), slates (U', N) item ids,
    -1-padded): every user with at least N candidates, in order."""
    slates, tests, users = [], [], []
    for u in range(ds.n_users):
        cand, rel = cands[u]
        if cand.size < N:
            continue
        local = np.asarray(select_fn(cand, rel))
        local = local[local >= 0]
        slates.append(np.pad(cand[local], (0, N - local.size), constant_values=-1))
        tests.append(ds.test[u])
        users.append(u)
    slates = np.stack(slates)
    rec = recall_at_n(slates, np.asarray(tests))
    div = mean_slate_diversity(slates, S)
    return rec, div, np.asarray(users), slates


def run_dataset(name, N, K, alphas, thetas, bs, seed=0, device=None):
    """The rows ``(algo, recall, diversity)`` of one dataset, and what
    they were computed from: ``{"S", "cands", "users", "slates": {algo:
    (U', N)}}``."""
    dev = resolve_device(device)
    ds = load_preset(name, seed=seed)
    S = item_similarity(ds)
    cands = candidates_and_relevance(ds, S, top_k_similar=K)
    rng = np.random.default_rng(seed)
    rows, slates = [], {}

    def on_device(x):
        return torch.as_tensor(x, device=dev)

    def add(algo, fn):
        rec, div, users, sl = eval_algorithm(ds, S, cands, N, fn)
        rows.append((algo, rec, div))
        slates[algo] = sl
        return users

    for b in bs:
        add(f"random_b{b}", lambda cand, rel, b=b: random_top_select(
            np.asarray(rel), N, b, rng))
    for th in thetas:
        for algo, select in (("mmr", mmr_select),
                             ("greedy", greedy_avg_select)):
            add(f"{algo}_t{th}", lambda cand, rel, th=th, select=select:
                select(on_device(normalize(rel)),
                       on_device(S[np.ix_(cand, cand)]), N, th).cpu())

    def dpp_fn(cand, rel, a):
        L = build_kernel_dense(on_device(normalize(rel)),
                               on_device(S[np.ix_(cand, cand)]), alpha=a)
        return dpp_greedy_dense(L, N, eps=DPP_EPS).indices.cpu()

    users = None
    for a in alphas:
        users = add(f"divdpp_a{a}", lambda cand, rel, a=a: dpp_fn(cand, rel, a))
    return rows, dict(S=S, cands=cands, users=users, slates=slates)


def run(fast_mode=False, device=None, seed=0):
    """``{dataset: (rows, detail)}`` at ``repro``'s sweep sizes."""
    alphas = (1.0, 4.0, 64.0) if fast_mode else (1.0, 2.0, 4.0, 16.0, 64.0, 256.0)
    thetas = (0.3, 0.7) if fast_mode else (0.1, 0.3, 0.5, 0.7, 0.9)
    bs = (0, 1) if fast_mode else (0, 1, 2)
    names = ["jester-like"] if fast_mode else list(DATASETS)
    return {name: run_dataset(name, DATASETS[name]["N"], DATASETS[name]["K"],
                              alphas, thetas, bs, seed=seed, device=device)
            for name in names}


def main(fast_mode=False, device=None):
    dev = resolve_device(device)
    out = run(fast_mode, dev)
    print(device_line(dev))
    print("name,us_per_call,derived")
    for name, (rows, _) in out.items():
        for algo, rec, div in rows:
            print(f"fig3_{name}_{algo},0,recall={rec:.4f};avg={div['avg']:.4f};"
                  f"min={div['min']:.4f};median={div['median']:.4f}")
    return out


if __name__ == "__main__":
    fast, dev = parse(__doc__)
    main(fast_mode=fast, device=dev)
