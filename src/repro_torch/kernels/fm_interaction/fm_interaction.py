"""Fused FM second-order interaction (K8), the CUDA counterpart of
``repro/kernels/fm_interaction/fm_interaction.py``'s ``_kernel``
(``csrc/fm_interaction.cu``).

One thread block per ``block_b`` examples stages its examples' (F, D)
embeddings through shared memory and writes one float32 per example;
the ragged last block is masked in the kernel, nothing is padded.  The
wrapper runs the plain PyTorch version for CPU tensors (the tests) and
launches the kernel for CUDA tensors, or raises.  Neither has a
backward: a tensor that requires grad is refused.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

_SRC = Path(__file__).resolve().parent / "csrc" / "fm_interaction.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"fm_interaction_f32": _ARGS, "fm_interaction_bf16": _ARGS}
_ENTRY = {torch.float32: "fm_interaction_f32",
          torch.bfloat16: "fm_interaction_bf16"}
TILE_SMEM_BYTES = 48 * 1024  # shared memory one tile of examples may take
MAX_SMEM_BYTES = 227 * 1024  # a Hopper block's dynamic shared memory


def fm_tile(F: int, D: int, block_b: int) -> tuple[int, int]:
    """(examples staged per tile, dynamic shared-memory bytes): as many
    examples as fit ``TILE_SMEM_BYTES`` (at least one, at most
    ``block_b``); each takes F * D staged values and D partial terms."""
    per = 4 * (F + 1) * D
    if per > MAX_SMEM_BYTES:
        raise ValueError(
            f"one example's (F={F}, D={D}) embeddings need {per} bytes of "
            f"shared memory, above the {MAX_SMEM_BYTES} a block can hold"
        )
    tile = max(1, min(block_b, TILE_SMEM_BYTES // per))
    return tile, tile * per


def _refuse_grad(emb: torch.Tensor) -> None:
    if emb.requires_grad:
        raise RuntimeError(
            "fm_interaction has no backward (nor has the Pallas kernel it "
            "replaces): call it under torch.inference_mode() or "
            "torch.no_grad(), or pass force_ref=True for a differentiable "
            "plain version"
        )


def fm_interaction_kernel(emb: torch.Tensor,
                          block_b: int = 128) -> torch.Tensor:
    """K8: emb (N, F, D) float32 or bfloat16 -> (N,) float32, one launch.
    Its plain version is ``fm_interaction_ref`` (``block_b`` changes
    nothing there)."""
    _refuse_grad(emb)
    if emb.device.type == "cpu":
        return fm_interaction_ref(emb)
    if emb.ndim != 3:
        raise ValueError(
            f"emb must be (N, F, D), got shape {tuple(emb.shape)}")
    if emb.dtype not in _ENTRY:
        raise TypeError(f"emb must be float32 or bfloat16, got {emb.dtype}")
    if block_b <= 0:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    N, F, D = emb.shape
    cuda.require(emb, "emb", emb.dtype, (N, F, D))
    out = torch.empty((N,), dtype=torch.float32, device=emb.device)
    if N == 0:
        return out
    tile, smem = fm_tile(F, D, block_b)
    lib = cuda.library(_SRC, _SIGNATURES)
    err = getattr(lib, _ENTRY[emb.dtype])(
        emb.data_ptr(), out.data_ptr(), N, F, D, block_b, tile, smem,
        cuda.stream_ptr(emb),
    )
    cuda.count_launch("fm_interaction")
    cuda.check(err, "fm_interaction")
    return out
