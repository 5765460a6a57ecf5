"""K8's launch plan (``repro_torch.kernels.fm_interaction.fm_plan``) on the
CPU: the persistent grid's tiles cover every example exactly once, every
bulk copy is 16-byte aligned in address and size for views 0-3 elements
into their storage (the rest on the plain-load path), the ring fits a
block's shared memory, every shape the earlier one-block-per-128-examples
plan took is still planned, and the kernel's division by reciprocals
equals integer division.  No card: the plan is plain Python, which the
wrapper, these tests and the static checks read alike.
"""
import importlib
import math

import pytest
import torch

# the module (the package re-exports a function of the same name)
fm = importlib.import_module(
    "repro_torch.kernels.fm_interaction.fm_interaction")

DTYPES = [torch.float32, torch.bfloat16]
# (N, F, D): DeepFM's train batch and serve_p99's scored rows, one example
# past half a block (208 KB in float32), N = 1, N below the grid, ragged
# N, odd F * D, other recsys widths
SHAPES = [(65_536, 39, 10), (1_024_000, 39, 10), (3, 400, 130), (1, 39, 10),
          (100, 39, 10), (8191, 39, 10), (1000, 13, 7), (4099, 3, 5),
          (257, 4, 8), (1000, 26, 32), (130, 1, 1)]
CAPACITIES = (264, 132, 1)  # two blocks an SM, one, a single block


def _cases():
    for N, F, D in SHAPES:
        for block_b in (32, 64, 128):
            if N == 1_024_000 and block_b != 128:
                continue  # 50,000+ tiles: the default only
            yield N, F, D, block_b


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("N,F,D,block_b", list(_cases()))
def test_fm_plan_covers_aligns_and_fits(N, F, D, block_b, dtype):
    isz = dtype.itemsize
    ex = F * D * isz
    T0, S, stage, smem = fm.fm_layout(F, D, dtype, block_b)
    # the ring and the aux arrays fit a block, stages hold T0 examples
    assert 1 <= T0 <= block_b and 0 <= S <= fm.MAX_STAGES
    assert smem == fm.HEADER_BYTES * (S > 0) + S * stage + 8 * T0 * D
    assert smem <= fm.MAX_SMEM_BYTES
    assert S * stage <= fm.MAX_SMEM_BYTES
    if S:
        assert stage % 16 == 0 and stage >= T0 * ex + 15
    # a ring of two or more stages wherever two stages of one example fit
    if 2 * (-(-ex // 16) * 16 + 16) + fm.HEADER_BYTES + 8 * D \
            <= fm.MAX_SMEM_BYTES:
        assert S >= 2
    a = fm.example_align(F, D, isz)
    assert a == 16 // math.gcd(ex, 16)
    for cap in CAPACITIES:
        plan = fm.fm_plan(N, F, D, dtype, block_b, cap)
        assert (plan.stages, plan.stage_bytes, plan.smem_bytes) == (
            S, stage, smem)
        assert plan.threads == fm.THREADS <= fm.MAX_THREADS
        assert (T0 + 1) // 2 <= plan.tile <= T0
        if T0 % a == 0:
            assert plan.tile % a == 0  # tiles of an aligned emb start aligned
        assert plan.tiles == -(-N // plan.tile)
        assert plan.grid == min(plan.tiles, cap)
        # coverage: every block takes a tile, every example exactly once
        seen = []
        for b in range(plan.grid):
            tiles = list(fm.block_tiles(plan, b))
            assert tiles and tiles == sorted(tiles)
            seen += tiles
        assert sorted(seen) == list(range(plan.tiles))
        assert (plan.tiles - 1) * plan.tile < N <= plan.tiles * plan.tile
    # alignment: every bulk copy at storage offsets of 0-3 elements
    plan = fm.fm_plan(N, F, D, dtype, block_b, CAPACITIES[0])
    tiles = range(plan.tiles) if plan.tiles <= 4096 else sorted(
        {*range(64), plan.tiles - 1})
    for off in range(4):
        bulk = 0
        for t in tiles:
            c = fm.tile_copy(plan, N, F, D, isz, off * isz, t)
            nt = min(plan.tile, N - t * plan.tile)
            start = off * isz + t * plan.tile * ex
            assert c.size % 16 == 0
            assert c.size + c.plain * isz == nt * ex
            if c.size:
                bulk += 1
                assert c.src % 16 == 0 and c.dst % 16 == 0
                assert start <= c.src and c.src + c.size <= start + nt * ex
                assert c.dst == start % 16 + c.src - start
                assert c.dst + c.size <= plan.stage_bytes
                # at most 15 bytes at each end by plain loads
                assert c.plain * isz <= 30
            assert start % 16 + nt * ex <= plan.stage_bytes or not S
            if off == 0 and T0 % a == 0 and nt == plan.tile:
                assert c.plain == 0  # an aligned full tile: one bulk copy
        if S and plan.tile * ex >= 32:
            assert bulk > 0


def _parent_takes(F, D):
    """The earlier plan (``fm_tile``) raised only past 227 KB of one
    example's F * D float32 values and D partial terms."""
    return 4 * (F + 1) * D <= fm.MAX_SMEM_BYTES


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("F,D", [(39, 10), (400, 130), (1, 1), (13, 7),
                                 (446, 130), (447, 130), (58111, 1),
                                 (58112, 1), (1, 29055), (1, 29056),
                                 (2, 19370), (2, 19371)])
def test_fm_plan_takes_every_shape_the_earlier_plan_took(F, D, dtype):
    """The plan raises exactly where the earlier one did; at the edge an
    example that no stage holds beside the aux arrays runs on the
    plain-load path (S = 0)."""
    if _parent_takes(F, D):
        T0, S, stage, smem = fm.fm_layout(F, D, dtype, 128)
        assert smem <= fm.MAX_SMEM_BYTES
        plan = fm.fm_plan(5, F, D, dtype, 128, 264)
        assert plan.grid >= 1 and plan.tiles * plan.tile >= 5
        if S == 0:
            assert (T0, stage) == (1, 0)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            fm.fm_layout(F, D, dtype, 128)


def test_fm_plan_balances_the_last_round():
    """At DeepFM's train batch on two blocks an SM the tile shrinks so the
    last round of the persistent grid is nearly full (one tile a block
    of slack at most 1.5%)."""
    for dtype, T in ((torch.float32, 18), (torch.bfloat16, 36)):
        plan = fm.fm_plan(65_536, 39, 10, dtype, 128, 264)
        assert plan.tile == T and plan.grid == 264
        rounds = -(-plan.tiles // plan.grid)
        assert 65_536 / (plan.tile * plan.grid * rounds) > 0.985
    # a single round keeps the layout's tile
    plan = fm.fm_plan(100, 39, 10, torch.float32, 128, 264)
    assert plan.tile == fm.fm_layout(39, 10, torch.float32, 128)[0]


def test_fm_plan_refuses_empty_and_bad_arguments():
    for args in ((0, 39, 10, torch.float32, 128, 264),
                 (5, 39, 10, torch.float32, 0, 264),
                 (5, 39, 10, torch.float32, 128, 0)):
        with pytest.raises(ValueError):
            fm.fm_plan(*args)
    with pytest.raises(TypeError):
        fm.fm_layout(39, 10, torch.float16, 128)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 10, 13, 390, 1024, 52_000,
                               58_111, 2 ** 20 + 1])
def test_divmod_magic_is_integer_division(d):
    """The kernel's fast_div (a multiply-high by divmod_magic's
    reciprocal) equals x // d over 0 <= x < 2^31."""
    mul, shr = fm.divmod_magic(d)
    assert 0 <= mul < 2 ** 32
    xs = {0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 31 - 1 - d,
          2 ** 31 - 1 - (2 ** 31 - 1) % d}
    xs |= {q * d + r for q in (1, 7, 1000, 2 ** 31 // d - 1)
           for r in (0, d - 1) if q * d + r < 2 ** 31}
    xs |= set(range(0, min(2 ** 31, 60 * d), max(1, d // 7)))
    for x in xs:
        assert fm.fast_div(x, d, mul, shr) == x // d, x
