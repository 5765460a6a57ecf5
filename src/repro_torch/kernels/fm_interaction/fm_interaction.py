"""Fused FM second-order interaction (K8), the CUDA counterpart of
``repro/kernels/fm_interaction/fm_interaction.py``'s ``_kernel``
(``csrc/fm_interaction.cu``).

One thread block per ``block_b`` examples stages its examples' (F, D)
embeddings through shared memory and writes one float32 per example;
the ragged last block is masked in the kernel, nothing is padded.

The backward is written by hand too (``fm_interaction_bwd_kernel``; the
Pallas kernel has none, ``repro`` differentiates its jnp
``fm_second_order`` with ``jax.grad``): ``grad[n, f, d] = g[n] * (s[n, d]
- v[n, f, d])`` with ``s = sum_f v`` in float32, over the same tiles.
``FMInteraction``, a ``torch.autograd.Function``, binds the two.

Each wrapper runs its plain PyTorch version for CPU tensors (the tests)
and launches its kernel for CUDA tensors, or raises: no path on the card
gives way to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.fm_interaction.ref import (
    fm_interaction_bwd_ref,
    fm_interaction_ref,
)

_SRC = Path(__file__).resolve().parent / "csrc" / "fm_interaction.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I, _P]
_BWD_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"fm_interaction_f32": _ARGS, "fm_interaction_bf16": _ARGS,
               "fm_interaction_bwd_f32": _BWD_ARGS,
               "fm_interaction_bwd_bf16": _BWD_ARGS}
_ENTRY = {torch.float32: "fm_interaction_f32",
          torch.bfloat16: "fm_interaction_bf16"}
_BWD_ENTRY = {torch.float32: "fm_interaction_bwd_f32",
              torch.bfloat16: "fm_interaction_bwd_bf16"}
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


def _check_emb(emb: torch.Tensor, block_b: int) -> None:
    if emb.ndim != 3:
        raise ValueError(
            f"emb must be (N, F, D), got shape {tuple(emb.shape)}")
    if emb.dtype not in _ENTRY:
        raise TypeError(f"emb must be float32 or bfloat16, got {emb.dtype}")
    if block_b <= 0:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    cuda.require(emb, "emb", emb.dtype, tuple(emb.shape))


def _forward(emb: torch.Tensor, block_b: int) -> torch.Tensor:
    if emb.device.type == "cpu":
        return fm_interaction_ref(emb)
    _check_emb(emb, block_b)
    N, F, D = emb.shape
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


def fm_interaction_bwd_kernel(emb: torch.Tensor, g: torch.Tensor,
                              block_b: int = 128) -> torch.Tensor:
    """K8's backward: emb (N, F, D) float32 or bfloat16 and the output's
    gradient g (N,) -> the gradient of emb, (N, F, D) in emb's dtype, one
    launch.  Its plain version is ``fm_interaction_bwd_ref``."""
    if emb.device.type == "cpu":
        return fm_interaction_bwd_ref(emb, g)
    _check_emb(emb, block_b)
    N, F, D = emb.shape
    g = g.to(torch.float32).contiguous()
    cuda.require(g, "g", torch.float32, (N,))
    grad = torch.empty_like(emb)
    if N == 0:
        return grad
    tile, smem = fm_tile(F, D, block_b)
    lib = cuda.library(_SRC, _SIGNATURES)
    err = getattr(lib, _BWD_ENTRY[emb.dtype])(
        emb.data_ptr(), g.data_ptr(), grad.data_ptr(), N, F, D, block_b,
        tile, smem, cuda.stream_ptr(emb),
    )
    cuda.count_launch("fm_interaction_bwd")
    cuda.check(err, "fm_interaction_bwd")
    return grad


class FMInteraction(torch.autograd.Function):
    """K8 forward and its hand-written backward (the plain versions of
    both on CPU tensors).  ``emb`` is saved only when its gradient is
    wanted."""

    @staticmethod
    def forward(ctx, emb: torch.Tensor, block_b: int) -> torch.Tensor:
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(emb)
        ctx.block_b = block_b
        return _forward(emb, block_b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        (emb,) = ctx.saved_tensors
        return fm_interaction_bwd_kernel(emb, g, ctx.block_b), None


def fm_interaction_kernel(emb: torch.Tensor,
                          block_b: int = 128) -> torch.Tensor:
    """K8: emb (N, F, D) float32 or bfloat16 -> (N,) float32, one launch,
    differentiable through ``FMInteraction``.  Its plain version is
    ``fm_interaction_ref`` (``block_b`` changes nothing there)."""
    return FMInteraction.apply(emb, block_b)
