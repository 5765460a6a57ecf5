"""Plain PyTorch oracles for the FM interaction kernel (K8) and its
backward."""
import torch


def fm_interaction_ref(emb: torch.Tensor) -> torch.Tensor:
    """emb (B, F, D) -> (B,) float32: 0.5 * sum_d[(sum_f v)^2 - sum_f v^2],
    computed in float32 (bf16 input upcast first; float64 input stays
    float64, for gradient checks)."""
    v = emb.to(torch.promote_types(emb.dtype, torch.float32))
    s = v.sum(1)
    sq = (v * v).sum(1)
    return 0.5 * (s * s - sq).sum(1)


def fm_interaction_bwd_ref(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``fm_interaction_ref`` at emb (B, F, D) for the
    output's gradient g (B,): g[b] * (sum_f v[b, f, d] - v[b, f, d]) in
    float32 (float64 for float64 input), rounded once to emb's dtype."""
    dt = torch.promote_types(emb.dtype, torch.float32)
    v = emb.to(dt)
    s = v.sum(1, keepdim=True)
    return (g.to(dt)[:, None, None] * (s - v)).to(emb.dtype)
