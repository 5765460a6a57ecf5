"""Fused candidate scoring + per-block top-c (K7), the CUDA counterpart of
``repro/kernels/scored_topk/scored_topk.py``'s ``_kernel``
(``csrc/scored_topk.cu``).

One thread block per ``bm`` candidate rows scores them against the query
and keeps its top-c, found by a radix select over unique 64-bit (value,
lowest index) keys; only the ``nb * c`` block survivors reach device
memory.  Rows past M are scored -inf by global index inside the kernel,
so ``emb`` is never padded.  The wrapper runs the plain PyTorch version
for CPU tensors (the tests) and launches the kernel for CUDA tensors, or
raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import cuda

_SRC = Path(__file__).resolve().parent / "csrc" / "scored_topk.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"scored_topk_f32": _ARGS, "scored_topk_bf16": _ARGS}
_ENTRY = {torch.float32: "scored_topk_f32",
          torch.bfloat16: "scored_topk_bf16"}
LANE = 128  # block rows are a multiple of this, as in repro
MAX_SMEM_BYTES = 227 * 1024  # a Hopper block's dynamic shared memory


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def block_rows(M: int, c: int, block_m: int) -> int:
    """Rows per block, as ``repro``'s ``scored_topk_kernel`` sizes them:
    ``block_m`` cut to M, in multiples of 128, and at least c."""
    bm = _round_up(min(block_m, _round_up(M, LANE)), LANE)
    return max(bm, _round_up(c, LANE))


def select_smem_bytes(bm: int, c: int, D: int) -> tuple[int, int]:
    """(Q, the survivors sorted per block: a power of two >= c; the
    block's dynamic shared memory: bm keys, Q survivors and the staged
    query)."""
    Q = 1 << (c - 1).bit_length()
    return Q, 8 * (bm + Q) + 4 * D


def _check_args(emb, query, c, block_m):
    if emb.ndim != 2 or query.shape != (emb.shape[1],):
        raise ValueError(
            f"emb must be (M, D) and query (D,), got {tuple(emb.shape)} and "
            f"{tuple(query.shape)}"
        )
    if c < 1 or block_m < 1:
        raise ValueError(f"c and block_m must be >= 1, got {c}, {block_m}")


def scored_topk_blocks_plain(emb: torch.Tensor, query: torch.Tensor, c: int,
                             block_m: int = 8192):
    """Plain version of K7: the block survivors (vals (nb, c) float32,
    idx (nb, c) int32), each block's top-c of ``emb @ query`` by a stable
    descending sort, rows past M at -inf."""
    _check_args(emb, query, c, block_m)
    M = emb.shape[0]
    bm = block_rows(M, c, block_m)
    nb = -(-M // bm)
    s = torch.full((nb * bm,), float("-inf"), dtype=torch.float32,
                   device=emb.device)
    s[:M] = emb.to(torch.float32) @ query.to(torch.float32) + 0.0
    vals, pos = torch.sort(s.view(nb, bm), dim=1, descending=True,
                           stable=True)
    base = torch.arange(nb, device=emb.device)[:, None] * bm
    return vals[:, :c], (pos[:, :c] + base).to(torch.int32)


def scored_topk_blocks(emb: torch.Tensor, query: torch.Tensor, c: int,
                       block_m: int = 8192):
    """K7: the block survivors of ``emb @ query`` in one launch.  emb
    (M, D) and query (D,), both float32 or both bfloat16 -> (vals (nb, c)
    float32, idx (nb, c) int32), each row in (value descending, lowest
    index first) order."""
    if emb.device.type == "cpu":
        return scored_topk_blocks_plain(emb, query, c, block_m)
    _check_args(emb, query, c, block_m)
    if emb.dtype not in _ENTRY:
        raise TypeError(f"emb must be float32 or bfloat16, got {emb.dtype}")
    M, D = emb.shape
    cuda.require(emb, "emb", emb.dtype, (M, D))
    cuda.require(query, "query", emb.dtype, (D,))
    if M >= 2**31 - 1:
        raise ValueError(f"M={M} exceeds the kernel's 32-bit row ids")
    bm = block_rows(M, c, block_m)
    Q, smem = select_smem_bytes(bm, c, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"a block of {bm} rows keeping {c} needs {smem} bytes of shared "
            f"memory, above the {MAX_SMEM_BYTES} a block can hold: lower "
            f"block_m or c"
        )
    nb = -(-M // bm)
    vals = torch.empty((nb, c), dtype=torch.float32, device=emb.device)
    idx = torch.empty((nb, c), dtype=torch.int32, device=emb.device)
    lib = cuda.library(_SRC, _SIGNATURES)
    err = getattr(lib, _ENTRY[emb.dtype])(
        emb.data_ptr(), query.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        M, D, c, bm, Q, nb, smem, cuda.stream_ptr(emb),
    )
    cuda.count_launch("scored_topk")
    cuda.check(err, "scored_topk")
    return vals, idx
