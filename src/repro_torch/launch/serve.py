"""Batched serving driver with DPP slate diversification (the torch
counterpart of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --requests 32 --candidates 2000 --slate 10 --alpha 3.0

Serving pipeline per request batch (the paper's §5 scenario end to end),
``serve_batch``:
  1. score all candidates with the CTR model (one batched forward; the
     DeepFM FM term runs the fm_interaction kernel K8 on the card);
  2. shortlist the top-C;
  3. Div-DPP (Algorithm 1) reranks the shortlist into a diverse slate
     (``--use-kernel``: the greedy kernels K1-K6 on the card).

Reports throughput and slate diversity (average / min / median
dissimilarity, the paper's metrics) against a pure Top-N baseline, with
``repro``'s flags and output keys.  Two differences: ``--reduced`` can be
turned off (``--no-reduced`` serves the published config; ``repro``'s
flag is ``store_true`` with ``default=True``), and the diversity comes
from each slate's own feature rows instead of an (Mc, Mc) similarity
matrix.  ``--device`` (default ``cuda``) picks the device; the weights
are random, drawn from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import mean_slate_diversity_rows, top_n_select
from repro_torch.data import recsys_batches
from repro_torch.device import resolve_device
from repro_torch.models.recsys import (
    RecsysConfig,
    RecsysModel,
    init_params,
    item_embeddings,
    serve_scores,
)
from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest


def candidate_ids(user_ids: torch.Tensor, cand: torch.Tensor,
                  cfg: RecsysConfig) -> torch.Tensor:
    """user_ids (B, F, H), cand (Mc,) -> (B * Mc, F, H): each user's
    features once per candidate, the candidate id in the item field's
    first slot and -1 in its other H - 1 (``repro``'s ``score_one``,
    with the vmap written out as the batch)."""
    B, F, H = user_ids.shape
    Mc = cand.shape[0]
    ids = user_ids[:, None].expand(B, Mc, F, H).clone()
    ids[:, :, cfg.item_field, 0] = cand.to(ids.dtype)
    ids[:, :, cfg.item_field, 1:] = -1
    return ids.reshape(B * Mc, F, H)


def serve_batch(model: RecsysModel, user_ids: torch.Tensor,
                cand: torch.Tensor, cfg: RecsysConfig, rr: Reranker):
    """Score every candidate for every user, then rerank each user's
    top-C into a slate.  user_ids (B, F, H), cand (Mc,) item-field ids ->
    (scores (B, Mc) float32, slates (B, k) int32 candidate positions)."""
    with torch.inference_mode():
        B, Mc = user_ids.shape[0], cand.shape[0]
        ids = candidate_ids(user_ids, cand, cfg)
        scores = serve_scores(model, ids, cfg).reshape(B, Mc)
        feats = item_embeddings(model, cand, cfg)  # (Mc, D)
        slates, _ = rr.rerank(RerankRequest(scores=scores, feats=feats))
    return scores, slates


def report(arch: str, scores: torch.Tensor, slates: torch.Tensor,
           feats: torch.Tensor, t_first: float, t_steady: float) -> dict:
    """``repro``'s output record: timings, the DPP slates' diversity and
    mean relevance against the Top-N slates of the same scores."""
    scores = scores.cpu().numpy()
    slates = slates.cpu().numpy()
    feats = feats.cpu().numpy()
    B, k = slates.shape
    top = np.stack([top_n_select(scores[b], k) for b in range(B)])
    return {
        "arch": arch,
        "requests": B,
        "candidates": scores.shape[1],
        "first_batch_s": round(t_first, 3),
        "steady_batch_s": round(t_steady, 3),
        "req_per_s": round(B / t_steady, 1),
        "diversity_dpp": mean_slate_diversity_rows(slates, feats),
        "diversity_top": mean_slate_diversity_rows(top, feats),
        "mean_rel_dpp": float(np.take_along_axis(scores, slates, 1).mean()),
        "mean_rel_top": float(np.take_along_axis(scores, top, 1).mean()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepfm")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--candidates", type=int, default=2000)
    ap.add_argument("--slate", type=int, default=10)
    ap.add_argument("--shortlist", type=int, default=200)
    ap.add_argument("--alpha", type=float, default=3.0)
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "recsys":
        raise ValueError("the serving driver targets the recsys family")
    cfg = spec.reduced() if args.reduced else spec.config
    device = resolve_device(args.device)
    model = init_params(torch.Generator(device).manual_seed(0), cfg)
    Mc = min(args.candidates, cfg.vocab_sizes[cfg.item_field])
    B = args.requests
    rr = Reranker(DPPRerankConfig(
        slate_size=args.slate, shortlist=min(args.shortlist, Mc),
        alpha=args.alpha, use_kernel=args.use_kernel,
    ), device=device)

    # candidate item ids are shared; user contexts vary per request
    cand = torch.arange(Mc, dtype=torch.int32, device=device)
    user = torch.as_tensor(next(recsys_batches(cfg.vocab_sizes, B, seed=1))
                           ["ids"], device=device)  # (B, F, H)

    def timed():
        t0 = time.perf_counter()
        out = serve_batch(model, user, cand, cfg, rr)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    _, t_first = timed()
    (scores, slates), t_steady = timed()
    with torch.inference_mode():
        feats = item_embeddings(model, cand, cfg)
    out = report(args.arch, scores, slates, feats, t_first, t_steady)
    print(json.dumps(out, indent=1))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
