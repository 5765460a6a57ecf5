"""Quickstart: diversify a top-N slate with fast greedy DPP MAP inference
on the card; the counterpart of ``repro``'s ``examples/quickstart.py``.

  python -m repro_torch.examples.quickstart [--device cuda|cpu]

The kernel ``L = Diag(alpha^r) S Diag(alpha^r)`` (paper eq. (22)) is
passed in its low-rank form ``V = F Diag(alpha^r)``, ``L = V^T V``, to the
kernel backend: K1 on the card (its plain version with ``--device
cpu``).  At alpha = 1 every item's first gain is its squared norm, 1 up
to float32 rounding, so the first pick is a near-tie that the summation
order decides: that row may differ from ``repro``'s dense-path example.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    GreedySpec,
    greedy_map,
    normalize_columns,
    scaled_features,
    similarity_from_features,
    slate_diversity,
    top_n_select,
)
from repro_torch.device import resolve_device

M, D, N = 500, 64, 10
ALPHAS = (1.0, 2.0, 8.0, 64.0)


def setup(device=None):
    """Item relevance scores (M,) (e.g. CTR model outputs) and unit-norm
    item features (D, M), float32 on the device, from seed 0."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    relevance = torch.as_tensor(rng.uniform(size=M), dtype=torch.float32,
                                device=dev)
    feats = normalize_columns(torch.as_tensor(
        rng.normal(size=(D, M)), dtype=torch.float32, device=dev))
    return relevance, feats


def main(device=None):
    """Print relevance and diversity of the DPP slate at each alpha and of
    the Top-N slate; returns ``{alpha: slate}`` ((N,) int64 numpy)."""
    relevance, feats = setup(device)
    S = similarity_from_features(feats).cpu().numpy()
    rel = relevance.cpu().numpy()
    spec = GreedySpec(k=N, backend="kernel")  # paper Algorithm 1, K1

    print("alpha  recall-proxy(sum rel)  avg-dissim  min-dissim")
    slates = {}
    for alpha in ALPHAS:
        V = scaled_features(feats, relevance, alpha)  # L = V^T V, eq. (22)
        sel = greedy_map(spec, V=V).indices.cpu().numpy().astype(np.int64)
        div = slate_diversity(sel, S)
        print(f"{alpha:5.1f}  {rel[sel[sel >= 0]].sum():20.3f}  "
              f"{div['avg']:.4f}      {div['min']:.4f}")
        slates[alpha] = sel

    top = top_n_select(rel, N)
    div = slate_diversity(top, S)
    print(f"top-N  {rel[top].sum():20.3f}  {div['avg']:.4f}      "
          f"{div['min']:.4f}")
    print("\nlarger alpha -> closer to pure Top-N; alpha=1 -> pure diversity.")
    return slates


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
