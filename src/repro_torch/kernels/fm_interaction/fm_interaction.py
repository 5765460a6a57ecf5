"""Fused FM second-order interaction (K8), the CUDA counterpart of
``repro/kernels/fm_interaction/fm_interaction.py``'s ``_kernel``
(``csrc/fm_interaction.cu``), and its hand-written backward.

A persistent grid of blocks walks tiles of ``T`` consecutive examples,
each tile one contiguous span of emb brought into a ring of ``S``
shared-memory stages by bulk copies, ``S - 1`` tiles in flight while the
block sums the current one; the ragged last tile and a view's unaligned
start are taken by plain loads inside the kernel, nothing is padded.
:func:`fm_plan` sizes all of it; the wrapper, the tests and the static
checks read it.

The backward (``fm_interaction_bwd_kernel``; the Pallas kernel has none,
``repro`` differentiates its jnp ``fm_second_order`` with ``jax.grad``)
computes ``grad[n, f, d] = g[n] * (s[n, d] - v[n, f, d])`` with ``s =
sum_f v`` in float32 over the same ring and plan.  ``FMInteraction``, a
``torch.autograd.Function``, binds the two.

Each wrapper runs its plain PyTorch version for CPU tensors (the tests)
and launches its kernel for CUDA tensors, or raises: no path on the card
gives way to the plain version.  A fake tensor (``FakeTensorMode``, the
dry run's, ``repro_torch.launch.dryrun``) on any other device takes a
shape-only route: its output is allocated (as a fake tensor) and
nothing launches (:func:`shape_only`).  A meta tensor is refused, as
any tensor off the CPU and the card is.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.fm_interaction.ref import (
    fm_interaction_bwd_ref,
    fm_interaction_ref,
)

_SRC = Path(__file__).resolve().parent / "csrc" / "fm_interaction.cu"
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


class _Launch(ctypes.Structure):
    """The C entry's ``FMLaunch``: the plan's numbers and the reciprocals
    of F * D and D (:func:`_launch_args`)."""
    _fields_ = ([(n, _I) for n in ("N", "F", "D", "T", "S", "stage_bytes")]
                + [(n, _U) for n in ("per_mul", "per_shr", "d_mul", "d_shr")]
                + [(n, _I) for n in ("grid", "threads", "smem")])


_SIGNATURES = {
    "fm_interaction_launch": [_I, _P, _P, _P, ctypes.POINTER(_Launch), _P],
    "fm_interaction_set_smem": [_I, _I],
    "fm_interaction_capacity": [_I, _I, _I, _P],
}
_DTYPES = (torch.float32, torch.bfloat16)
# Mirrors of the kernel's constants (csrc/fm_interaction.cu)
MAX_STAGES = 8  # FM_MAX_STAGES
MAX_THREADS = 1024  # FM_MAX_THREADS
HEADER_BYTES = 64  # FM_HEADER: the stages' mbarriers (none without a ring)
MAX_SMEM_BYTES = 227 * 1024  # a Hopper block's dynamic shared memory


# The plan's blocks of 512 threads with up to three stages of about 32 KB:
# two blocks an SM keep about 125 KB a SM in flight while a tile is summed
# (the fastest or within 5% of it at DeepFM's shapes among the ten
# settings PERF.md records, on an H100)
THREADS = 512
STAGE_TARGET = 32 * 1024  # the bytes a stage aims at
STAGES = 3  # the most stages a plan takes (at most MAX_STAGES)


class FMPlan(NamedTuple):
    """How one launch of K8 (or its backward) covers N examples."""
    tile: int  # T: examples a tile, at most block_b
    stages: int  # S: ring stages; 0: every element by plain loads
    stage_bytes: int  # a stage: T * F * D * itemsize rounded to 16, + 16
    grid: int  # blocks: min(tiles, co-resident); block b takes tiles
    # b, b + grid, ...
    threads: int  # a block's
    smem_bytes: int  # dynamic shared memory a block
    tiles: int  # ceil(N / T)


def example_align(F: int, D: int, itemsize: int) -> int:
    """Examples whose bytes are a 16-byte multiple: 16 / gcd(F * D *
    itemsize, 16).  A tile of a multiple of this many starts 16-byte
    aligned wherever emb does."""
    return 16 // math.gcd(F * D * itemsize, 16)


def _stage_bytes(T: int, ex: int) -> int:
    return -(-T * ex // 16) * 16 + 16


def _smem(S: int, T: int, ex: int, D: int) -> int:
    """The header (where there is a ring), S stages of T examples of
    ``ex`` bytes, and the aux arrays (2 * T * D floats)."""
    return (HEADER_BYTES if S else 0) + S * _stage_bytes(T, ex) + 8 * T * D


@functools.lru_cache(maxsize=256)
def fm_layout(F: int, D: int, dtype: torch.dtype,
              block_b: int) -> tuple[int, int, int, int]:
    """(T, S, stage bytes, shared-memory bytes) for examples of (F, D) in
    ``dtype``, independent of N.  T: as many examples as fit
    ``STAGE_TARGET`` bytes (at least one, at most ``block_b``), a
    multiple of :func:`example_align` where that leaves one; S: the most
    stages up to ``STAGES`` that fit a block beside the aux
    arrays, shrinking T where even one stage of T does not fit; S = 0
    (plain loads) only where no stage of one example fits.  Raises
    ``ValueError`` where the earlier kernel did (one example's F * D
    float32 values and D partial terms past 227 KB)."""
    if dtype not in _DTYPES:
        raise TypeError(f"emb must be float32 or bfloat16, got {dtype}")
    if 4 * (F + 1) * D > MAX_SMEM_BYTES:
        raise ValueError(
            f"one example's (F={F}, D={D}) embeddings need "
            f"{4 * (F + 1) * D} bytes of shared memory, above the "
            f"{MAX_SMEM_BYTES} a block can hold"
        )
    ex = F * D * dtype.itemsize
    a = example_align(F, D, dtype.itemsize)
    T0 = max(1, min(block_b, STAGE_TARGET // ex))
    for S in range(STAGES, 0, -1):
        T = T0
        while T > 1 and _smem(S, T, ex, D) > MAX_SMEM_BYTES:
            T -= 1
        if T >= a:
            T -= T % a
        if _smem(S, T, ex, D) <= MAX_SMEM_BYTES:
            return T, S, _stage_bytes(T, ex), _smem(S, T, ex, D)
    return 1, 0, 0, _smem(0, 1, ex, D)


def _balance(N: int, T: int, capacity: int) -> float:
    """The share of the grid's tile slots (its rounds times its blocks)
    that T-example tiles of N fill."""
    tiles = -(-N // T)
    grid = min(tiles, capacity)
    return N / (T * grid * -(-tiles // grid))


def fm_plan(N: int, F: int, D: int, dtype: torch.dtype, block_b: int,
            capacity: int) -> FMPlan:
    """The launch over N >= 1 examples: :func:`fm_layout`'s ring, and a
    persistent grid of ``min(tiles, capacity)`` blocks of
    ``THREADS``, ``capacity`` the blocks the card keeps co-resident
    at the plan's shared memory.  Where the tiles take more than one round
    of the grid, the tile is the longest of the layout's T and shorter
    ones, down to half of it in steps of :func:`example_align`, that
    splits N within 1% as evenly over the rounds as the best of them, so
    the last round does not leave most blocks idle (at DeepFM's train
    batch in bfloat16 on 264 blocks, 40-example tiles fill 89% of 7
    rounds, 36-example ones 99%)."""
    if N < 1 or block_b < 1 or capacity < 1:
        raise ValueError(f"need N, block_b and capacity >= 1, got N={N}, "
                         f"block_b={block_b}, capacity={capacity}")
    T, S, stage, smem = fm_layout(F, D, dtype, block_b)
    a = example_align(F, D, dtype.itemsize)
    if S and T % a == 0 and -(-N // T) > capacity:
        lengths = range(T, (T + 1) // 2 - 1, -a)
        best = max(_balance(N, t, capacity) for t in lengths)
        T = next(t for t in lengths
                 if _balance(N, t, capacity) >= 0.99 * best)
    tiles = -(-N // T)
    return FMPlan(T, S, stage, min(tiles, capacity), THREADS, smem, tiles)


def block_tiles(plan: FMPlan, b: int) -> range:
    """The tiles block ``b`` takes, in order."""
    return range(b, plan.tiles, plan.grid)


class TileCopy(NamedTuple):
    """How tile ``t``'s span reaches its stage (the kernel's
    ``tile_span``): the bulk copy's source and destination offsets and
    size in bytes (size 0: none), the elements loaded plainly."""
    src: int  # bytes from the base emb's storage start, 16-byte aligned
    dst: int  # bytes into the stage
    size: int  # bytes, a multiple of 16
    plain: int  # elements at the span's two ends, by plain loads


def tile_copy(plan: FMPlan, N: int, F: int, D: int, itemsize: int,
              offset: int, t: int) -> TileCopy:
    """Tile ``t`` of a view that starts ``offset`` bytes past a 16-byte
    boundary, split as ``csrc/fm_interaction.cu``'s ``tile_span`` and
    ``fetch`` split it."""
    ex = F * D * itemsize
    nt = min(plan.tile, N - t * plan.tile)
    a = offset + t * plan.tile * ex
    b = a + nt * ex
    lo, hi = -(-a // 16) * 16, b // 16 * 16
    if hi <= lo:
        return TileCopy(b, 0, 0, nt * F * D)
    return TileCopy(lo, a % 16 + lo - a, hi - lo,
                    (lo - a + b - hi) // itemsize)


def divmod_magic(d: int) -> tuple[int, int]:
    """(multiplier, shift) with ``fast_div(x, d, ...) == x // d`` for
    0 <= x < 2^31 (CUTLASS's FastDivmod): the kernel divides by F * D and
    D this way instead of by a runtime value."""
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()
    return ((1 << p) + d - 1) // d, p - 32


def fast_div(x: int, d: int, mul: int, shr: int) -> int:
    """The kernel's ``fast_div``: ``__umulhi(x, mul) >> shr``."""
    return x if d == 1 else ((x * mul) >> 32) >> shr


# The kernels of csrc/fm_interaction.cu, by (backward, dtype)
_WHICH = {(False, torch.float32): 0, (False, torch.bfloat16): 1,
          (True, torch.float32): 2, (True, torch.bfloat16): 3}


@functools.lru_cache(maxsize=None)
def _capacity(which: int, threads: int, smem: int, index: int) -> int:
    """Blocks of kernel ``which`` of ``threads`` threads card ``index``
    keeps co-resident at ``smem`` bytes, with the kernel's shared-memory
    limit raised to it first (once a card and size, not before every
    launch)."""
    with torch.cuda.device(index):
        lib = cuda.library(_SRC, _SIGNATURES)
        cuda.raise_smem(lib, "fm_interaction_set_smem", which, smem,
                        torch.device("cuda", index))
        n = ctypes.c_int(0)
        cuda.check(lib.fm_interaction_capacity(which, threads, smem,
                                               ctypes.byref(n)),
                   "fm_interaction_capacity")
    return n.value


def _plan(backward: bool, N: int, F: int, D: int, dtype: torch.dtype,
          block_b: int, index: int) -> FMPlan:
    smem = fm_layout(F, D, dtype, block_b)[3]
    cap = _capacity(_WHICH[backward, dtype], THREADS, smem, index)
    return fm_plan(N, F, D, dtype, block_b, cap)


def _index(t: torch.Tensor) -> int:
    return (torch.cuda.current_device() if t.device.index is None
            else t.device.index)


def plan_for(emb: torch.Tensor, backward: bool,
             block_b: int = 128) -> FMPlan:
    """:func:`fm_plan` for a CUDA ``emb``, the co-resident blocks asked of
    its card once a kernel and size."""
    return _plan(backward, *emb.shape, emb.dtype, block_b, _index(emb))


@functools.lru_cache(maxsize=256)
def _launch_args(backward: bool, N: int, F: int, D: int,
                 dtype: torch.dtype, block_b: int, index: int):
    """The C entry's launch record for one shape on card ``index``: the
    plan, and the reciprocals of F * D and D, made once a shape (ctypes
    converts one pointer a launch, not 13 ints)."""
    plan = _plan(backward, N, F, D, dtype, block_b, index)
    return ctypes.pointer(_Launch(
        N, F, D, plan.tile, plan.stages, plan.stage_bytes,
        *divmod_magic(F * D), *divmod_magic(D), plan.grid, plan.threads,
        plan.smem_bytes))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The launch function, bound once."""
    return cuda.library(_SRC, _SIGNATURES).fm_interaction_launch


def _launch(backward: bool, emb: torch.Tensor, g, out: torch.Tensor,
            block_b: int) -> None:
    """One launch of K8 (``backward``: its gradient), counted."""
    err = _kernel()(_WHICH[backward, emb.dtype], emb.data_ptr(),
                    None if g is None else g.data_ptr(), out.data_ptr(),
                    _launch_args(backward, *emb.shape, emb.dtype, block_b,
                                 _index(emb)),
                    cuda.stream_ptr(emb))
    name = "fm_interaction_bwd" if backward else "fm_interaction"
    cuda.count_launch(name)
    cuda.check(err, name)


def _check_emb(emb: torch.Tensor, block_b: int) -> None:
    """Check K8's operand (a shape-only one for shape and dtype only)."""
    if emb.ndim != 3:
        raise ValueError(
            f"emb must be (N, F, D), got shape {tuple(emb.shape)}")
    if emb.dtype not in _DTYPES:
        raise TypeError(f"emb must be float32 or bfloat16, got {emb.dtype}")
    if block_b <= 0:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    if not shape_only(emb):
        cuda.require(emb, "emb", emb.dtype, tuple(emb.shape))


def shape_only(emb: torch.Tensor) -> bool:
    """Whether ``emb`` is a fake tensor (``FakeTensorMode``): it holds no
    data to launch on.  Only such a tensor off the CPU takes the
    wrappers' shape-only route; a real tensor never does."""
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(emb)


def _forward(emb: torch.Tensor, block_b: int) -> torch.Tensor:
    if emb.device.type == "cpu":
        return fm_interaction_ref(emb)
    _check_emb(emb, block_b)
    out = torch.empty((emb.shape[0],), dtype=torch.float32,
                      device=emb.device)
    if emb.shape[0] and not shape_only(emb):
        _launch(False, emb, None, out, block_b)
    return out


def fm_interaction_bwd_kernel(emb: torch.Tensor, g: torch.Tensor,
                              block_b: int = 128) -> torch.Tensor:
    """K8's backward: emb (N, F, D) float32 or bfloat16 and the output's
    gradient g (N,) -> the gradient of emb, (N, F, D) in emb's dtype, one
    launch.  Its plain version is ``fm_interaction_bwd_ref``."""
    if emb.device.type == "cpu":
        return fm_interaction_bwd_ref(emb, g)
    _check_emb(emb, block_b)
    g = g.to(torch.float32).contiguous()
    if not shape_only(emb):
        cuda.require(g, "g", torch.float32, (emb.shape[0],))
    grad = torch.empty_like(emb)
    if emb.shape[0] and not shape_only(emb):
        _launch(True, emb, g, grad, block_b)
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
    differentiable through ``FMInteraction`` (entered only where a
    gradient is wanted: serving skips its host time).  Its plain version
    is ``fm_interaction_ref`` (``block_b``, the most examples a tile
    takes, changes nothing there)."""
    if emb.requires_grad and torch.is_grad_enabled():
        return FMInteraction.apply(emb, block_b)
    return _forward(emb, block_b)
