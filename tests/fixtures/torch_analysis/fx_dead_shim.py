"""Seeded violations: dead-shim (serving names the port never had)."""
from repro_torch.serving import rerank  # LINE: dead-shim import
from repro_torch.serving.reranker import rerank_stream  # LINE: dead-shim
from repro_torch.serving.sharded_rerank import sharded_rerank  # mesh: fine

import repro_torch.serving as serving


def old_paths(scores, feats, cfg):
    a = rerank(scores, feats, cfg)
    b = rerank_stream(scores, feats, cfg)
    c = serving.rerank_batch(scores, feats, cfg)  # LINE: dead-shim attr
    d = sharded_rerank(scores, feats, cfg)  # the port's mesh backend
    return a, b, c, d


def new_path_is_fine():
    from repro_torch.serving import Reranker, RerankRequest  # noqa: F401
