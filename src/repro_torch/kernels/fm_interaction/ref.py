"""Plain PyTorch oracle for the FM interaction kernel (K8)."""
import torch


def fm_interaction_ref(emb: torch.Tensor) -> torch.Tensor:
    """emb (B, F, D) -> (B,) float32: 0.5 * sum_d[(sum_f v)^2 - sum_f v^2],
    computed in float32 (bf16 input upcast first)."""
    v = emb.to(torch.float32)
    s = v.sum(1)
    sq = (v * v).sum(1)
    return 0.5 * (s * s - sq).sum(1)
