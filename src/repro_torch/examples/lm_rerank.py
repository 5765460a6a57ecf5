"""LM-scored slate diversification: a transformer's mean-pooled final
hidden states as item embeddings, candidates scored against a query
context, and the slate diversified by the DPP rerank on K1; the
counterpart of ``repro``'s ``examples/lm_rerank.py``.

  python -m repro_torch.examples.lm_rerank [--device cuda|cpu]
      [--arch qwen1.5-4b] [--reduced | --no-reduced]

M = 256 items of 16 random tokens each (numpy, seed 0, as ``repro``
draws them) go through ``forward_hidden``; each item's embedding is its
mean hidden state, float32, normalised to unit length.  Item 0 is the
query: the scores are the embeddings' dot products with it.
``Reranker(DPPRerankConfig(slate_size=10, shortlist=64, alpha=4.0,
use_kernel=True))`` reranks them: K1 on the card at D = d_model (its
plain version on the CPU).  Weights are random from a seeded
``torch.Generator`` on the device (``repro``'s distributions, not its
numbers).  ``repro``'s example runs the reduced config; here the
published one is the default on the card and the reduced one on the CPU.
The diversities are computed from the slates' own rows
(``mean_slate_diversity_rows``), not from an M x M similarity matrix.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import mean_slate_diversity_rows, top_n_select
from repro_torch.device import resolve_device
from repro_torch.figures.common import sync
from repro_torch.models import transformer as tfm
from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

M, S = 256, 16  # items, tokens an item
RERANK = DPPRerankConfig(slate_size=10, shortlist=64, alpha=4.0,
                         use_kernel=True)


def build_model(arch: str, reduced: bool, device=None, seed: int = 0):
    """(cfg, random ``Transformer``) of ``arch``'s published or reduced
    config, drawn on ``device`` from a generator seeded with ``seed``."""
    spec = get_arch(arch)
    if spec.family != "lm":
        raise ValueError(f"{arch!r} is a {spec.family} arch; lm_rerank "
                         f"embeds items with an LM")
    cfg = spec.reduced() if reduced else spec.config
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return cfg, tfm.init_params(gen, cfg)


def item_tokens(vocab: int, seed: int = 0) -> np.ndarray:
    """(M, S) int64 token ids, ``repro``'s draw for the same seed."""
    return np.random.default_rng(seed).integers(0, vocab, size=(M, S))


def embed_items(model: tfm.Transformer, cfg: tfm.TransformerConfig,
                tokens: np.ndarray) -> torch.Tensor:
    """(M, d_model) float32 unit-norm rows on the model's device: the
    mean over each item's tokens of ``forward_hidden``."""
    toks = torch.as_tensor(tokens, device=model.embed.device)
    with torch.inference_mode():
        hidden, _, _ = tfm.forward_hidden(model, toks, cfg)
        emb = hidden.mean(dim=1).float()
        return emb / torch.clamp_min(
            torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-9)


def rerank_items(emb: torch.Tensor):
    """Score every item against item 0 and rerank: (DPP slate (10,)
    int32, Top-N slate (10,) int64, scores (M,)) as numpy."""
    scores = emb @ emb[0]
    rr = Reranker(RERANK, device=emb.device)
    slate, _ = rr.rerank(RerankRequest(scores=scores, feats=emb))
    scores = scores.cpu().numpy()
    return (slate.cpu().numpy(), top_n_select(scores, RERANK.slate_size),
            scores)


def main(device=None, arch: str = "qwen1.5-4b",
         reduced: Optional[bool] = None,
         model: Optional[tfm.Transformer] = None) -> dict:
    """Embed, score and rerank; print both slates and their diversities.
    ``reduced`` defaults to the published config on the card and the
    reduced one on the CPU; ``model`` (its own ``cfg``) replaces the
    random one.  Returns the slates, the embeddings and scores (numpy),
    the diversities and the forward's host seconds (synchronised)."""
    dev = resolve_device(device)
    if model is None:
        cfg, model = build_model(arch, dev.type == "cpu" if reduced is None
                                 else reduced, dev)
    cfg = model.cfg
    tokens = item_tokens(cfg.vocab)
    sync(dev)
    t0 = time.perf_counter()
    emb = embed_items(model, cfg, tokens)
    sync(dev)
    forward_s = time.perf_counter() - t0
    del model
    slate, top, scores = rerank_items(emb)
    emb = emb.cpu().numpy()
    div = mean_slate_diversity_rows(slate[None], emb)
    top_div = mean_slate_diversity_rows(top[None], emb)
    print("DPP slate:", slate.tolist())
    print("DPP diversity:", div)
    print("Top slate:", top.tolist())
    print("Top diversity:", top_div)
    return {"cfg": cfg, "slate": slate, "top": top, "emb": emb,
            "scores": scores, "diversity": div, "top_diversity": top_div,
            "forward_s": forward_s}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=None, help="the arch's reduced config (default: "
                    "on the CPU, not on the card)")
    args = ap.parse_args()
    main(args.device, args.arch, args.reduced)
