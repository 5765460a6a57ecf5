"""Plain PyTorch oracle for scored_topk (K7)."""
import torch


def scored_topk_ref(emb: torch.Tensor, query: torch.Tensor, c: int):
    """emb (M, D), query (D,) -> (vals (c,) float32, idx (c,) int32), the
    global top-c of ``emb @ query`` in float32.

    Ordered as ``jax.lax.top_k`` orders: value descending, then lowest
    index first.  ``torch.topk`` promises no order among ties, so this is
    a stable descending sort."""
    s = emb.to(torch.float32) @ query.to(torch.float32)
    vals, idx = torch.sort(s, descending=True, stable=True)
    return vals[:c], idx[:c].to(torch.int32)
