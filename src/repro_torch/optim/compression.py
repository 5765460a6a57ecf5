"""int8 gradient compression with error feedback (1-bit-Adam-style EF),
the torch counterpart of ``repro.optim.compression``.

Gradients are quantized to int8 with a symmetric per-tensor scale; the
quantization residual is carried in an error-feedback accumulator so the
compression bias telescopes away over steps (Seide et al. '14;
Karimireddy et al. '19).  Wired into the training step behind
``--grad-compression int8_ef``.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class ErrorFeedbackState(NamedTuple):
    residual: Dict[str, torch.Tensor]  # same names as the grads, f32


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 tensor -> (int8 tensor, scale). Symmetric per-tensor scaling."""
    amax = x.abs().max()
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(params: Dict[str, torch.Tensor]) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual={
        n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for n, p in params.items()})


@torch.no_grad()
def ef_compress_grads(grads: Dict[str, torch.Tensor],
                      state: ErrorFeedbackState):
    """Quantize (grad + residual); return (decompressed grads to feed the
    optimizer, new residual ``target - deq``)."""
    out, res = {}, {}
    for name, g in grads.items():
        target = g.to(torch.float32) + state.residual[name]
        q, scale = compress_int8(target)
        deq = decompress_int8(q, scale)
        out[name] = deq.to(g.dtype)
        res[name] = target - deq
    return out, ErrorFeedbackState(residual=res)
