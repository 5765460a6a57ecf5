"""K7 (``scored_topk``) as one launch over segments of rows: the plain
segmented version against ``repro``'s Pallas kernels in interpret mode,
the launch plan, and a numpy model of the kernel's grid-wide radix select.

On the CPU the wrappers run the plain version; the CUDA kernel is held
against it on a card (``test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: values rtol / atol 1e-5 on Gaussian data (float32 dot
products of D unit-normal terms in another order), with equal index
sets (a float32 near-tie may swap neighbours); index for index on
small-integer data, whose float32 dot products are exact in any order
and tie often, so the (value descending, lowest index first) order of
``jax.lax.top_k`` is tested exactly.
"""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.scored_topk import scored_topk as jax_topk
from repro.kernels.scored_topk.scored_topk import (
    scored_topk_kernel as jax_topk_blocks,
)
from repro_torch.kernels.scored_topk import (
    launch_plan,
    scored_topk_blocks_plain,
    scored_topk_ref,
    scored_topk_segments,
    scored_topk_segments_plain,
)
from repro_torch.kernels.scored_topk.scored_topk import (
    MAX_SMEM_BYTES,
    block_rows,
    capacity_smem,
)

# the module (the package's ``scored_topk`` attribute is the function)
sk = importlib.import_module("repro_torch.kernels.scored_topk.scored_topk")
TK_RTOL, TK_ATOL = 1e-5, 1e-5
HEADER = sk.HEADER_BYTES  # shared memory before the q vector and region
H100_SMS = 132
SM_SMEM = 228 * 1024  # an H100 SM's shared memory; 1 KB of it reserved a CTA
F32, BF16 = torch.float32, torch.bfloat16
SHAPES = [(1000, 16, 8, 256), (4097, 16, 128, 1024), (130, 64, 64, 128),
          (5000, 8, 300, 1024), (3000, 4, 1000, 8192), (2051, 10, 5, 512)]


def _ints(M, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-2, 3, size=(M, D)).astype(np.float32),
            rng.integers(-2, 3, size=(D,)).astype(np.float32))


# ---------------------------------------------------------------------------
# The plain segmented version against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,D,c,bm", SHAPES)
def test_segments_plain_equals_pallas_exact(M, D, c, bm):
    """Blocks mode (seg = the block rows) and global mode (seg = M) equal
    ``repro``'s block survivors and global top-c index for index."""
    e, q = _ints(M, D, M + c)
    je, jq = jnp.asarray(e), jnp.asarray(q)
    te, tq = torch.from_numpy(e), torch.from_numpy(q)
    bv, bi = jax_topk_blocks(je, jq, c=c, block_m=bm, interpret=True)
    pv, pi = scored_topk_segments_plain(te, tq, c, block_rows(M, c, bm))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(bi))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(bv))
    vals, idx = jax_topk(je, jq, c=c, block_m=bm, interpret=True)
    assert len(np.unique(np.asarray(vals))) < c  # the data does tie
    gv, gi = scored_topk_segments_plain(te, tq, c, M)
    assert gv.shape == (1, c)
    np.testing.assert_array_equal(gi[0].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(gv[0].numpy(), np.asarray(vals))
    rv, ri = scored_topk_ref(te, tq, c)
    assert torch.equal(ri, gi[0]) and torch.equal(rv, gv[0])


@pytest.mark.parametrize("M,D,c,bm", SHAPES)
@pytest.mark.parametrize("dtype", [(jnp.float32, F32), (jnp.bfloat16, BF16)],
                         ids=["f32", "bf16"])
def test_segments_plain_matches_pallas_gaussian(M, D, c, bm, dtype):
    jdt, tdt = dtype
    rng = np.random.default_rng(M * 3 + D)
    je = jnp.asarray(rng.normal(size=(M, D)), jdt)
    jq = jnp.asarray(rng.normal(size=(D,)), jdt)
    te = torch.from_numpy(np.array(je.astype(jnp.float32))).to(tdt)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(tdt)
    bv, bi = jax_topk_blocks(je, jq, c=c, block_m=bm, interpret=True)
    pv, pi = scored_topk_blocks_plain(te, tq, c, bm)
    np.testing.assert_allclose(pv.numpy(), np.asarray(bv), rtol=TK_RTOL,
                               atol=TK_ATOL)
    for r in range(pi.shape[0]):
        assert set(pi[r].tolist()) == set(np.asarray(bi)[r].tolist())
    vals, idx = jax_topk(je, jq, c=c, block_m=bm, interpret=True)
    gv, gi = scored_topk_segments(te, tq, c, M)  # CPU: the plain version
    np.testing.assert_allclose(gv[0].numpy(), np.asarray(vals), rtol=TK_RTOL,
                               atol=TK_ATOL)
    assert set(gi[0].tolist()) == set(np.asarray(idx).tolist())
    assert (gi < M).all()


def test_segments_plain_refuses_c_above_seg():
    e, q = torch.zeros(300, 4), torch.zeros(4)
    with pytest.raises(ValueError, match="c <= seg"):
        scored_topk_segments_plain(e, q, 200, 128)
    with pytest.raises(ValueError, match="must be >= 1"):
        scored_topk_segments(e, q, 0, 128)


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------


def _h100_capacity(D, c, dtype):
    """CTAs an H100 keeps co-resident at the plan's largest shared memory,
    counted from its 228 KB an SM (the card answers this at run time)."""
    per_sm = min(8, SM_SMEM // (capacity_smem(D, c, dtype) + 1024))
    return per_sm * H100_SMS


def _ranges(plan, seg):
    """The kernel's row ranges [first, end) of each CTA: CTA b is part
    b % cps of segment b // cps and owns an even run of its tiles."""
    T, cps = plan.tile_rows, plan.ctas_per_seg
    ntiles = -(-seg // T)
    out = []
    for b in range(plan.grid):
        s, p = divmod(b, cps)
        lo, hi = ntiles * p // cps, ntiles * (p + 1) // cps
        out.append((s * seg + lo * T, s * seg + min(hi * T, seg)))
    return out


@pytest.mark.parametrize("M,D,c,seg", [
    (10**6, 100, 1000, 8192), (10**6, 100, 1000, 10**6), (1_000_003, 10, 128,
                                                          1_000_003),
    (100_000, 16, 1000, 8192), (4097, 16, 128, 1024), (130, 64, 64, 128),
    (7, 3, 7, 7), (10**6, 100, 100, 128), (5_000_000, 64, 16, 5_000_000),
    (30_000, 8000, 10, 30_000)])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_plan_ranges_cover_each_segment_once(M, D, c, seg, dtype):
    """The CTAs' row ranges cover each segment exactly once, never cross
    one and fit the CTA's key slots; the shared memory fits a block, the
    capacity query's size and the final sort of the gather slots."""
    plan = launch_plan(M, D, c, seg, dtype, _h100_capacity(D, c, dtype))
    assert plan.segs == -(-M // seg) and plan.grid == plan.segs * plan.ctas_per_seg
    if plan.ctas_per_seg > 1:  # cooperative: the whole grid co-resident
        assert plan.grid <= _h100_capacity(D, c, dtype)
    cover = np.zeros(plan.segs * seg, dtype=np.int64)
    for b, (r0, r1) in enumerate(_ranges(plan, seg)):
        s = b // plan.ctas_per_seg
        assert s * seg <= r0 < r1 <= (s + 1) * seg  # never crosses one
        assert r1 - r0 <= plan.key_slots
        cover[r0:r1] += 1
    assert (cover == 1).all()
    Q = 1 << (c - 1).bit_length()
    assert plan.gather >= Q and plan.gather & (plan.gather - 1) == 0
    assert HEADER + (4 << plan.bits0) + 8 * plan.gather <= plan.smem_bytes
    assert plan.smem_bytes <= capacity_smem(D, c, dtype) <= MAX_SMEM_BYTES
    assert MAX_SMEM_BYTES == 232_448


@pytest.mark.parametrize("seg", [8192, 10**6], ids=["blocks", "global"])
def test_plan_fills_the_h100_at_the_timed_shape(seg):
    """Phase 12's timed shape (10^6 x 100 f32, c = 1000): two CTAs an SM,
    every SM busy in both modes, tiles of 64 rows (a group of 8 for each
    warp) in a ring of 3, keys on chip beside it."""
    cap = _h100_capacity(100, 1000, F32)
    assert cap == 2 * H100_SMS
    plan = launch_plan(10**6, 100, 1000, seg, F32, cap)
    assert plan.grid >= H100_SMS and plan.ctas_per_seg >= 2
    assert plan.keys_on_chip and plan.tile_rows == 64 and plan.stages == 3
    assert plan.key_slots == (4096 if seg == 8192 else 3840)
    assert plan.gather == (1024 if seg == 8192 else 4096)  # sorted, ranked
    assert plan.bits0 == 10
    assert plan.smem_bytes == (128 + 4096 + 400 + 3 * (64 * 400 + 16)
                               + 8 * plan.key_slots)


def test_plan_keys_go_to_device_memory_past_the_on_chip_size():
    cap = _h100_capacity(100, 1000, F32)
    small = launch_plan(1_100_000, 100, 1000, 1_100_000, F32, cap)
    big = launch_plan(2_000_000, 100, 1000, 2_000_000, F32, cap)
    assert small.keys_on_chip and 8 * small.key_slots <= sk.KEYS_SMEM_BYTES
    assert not big.keys_on_chip
    assert big.key_slots == -(-31250 // big.grid) * 64
    assert big.scratch_bytes == (4 * sk.SCRATCH_WORDS + 8 * big.gather
                                 + 8 * big.key_slots * big.grid)
    assert big.smem_bytes < small.smem_bytes  # the ring and the sort only


def test_plan_rows_longer_than_a_stage_take_plain_loads():
    p = launch_plan(10_000, 8000, 10, 10_000, F32, 264)  # 32 KB rows
    assert p.tile_rows == 64 and p.stages == 0
    p = launch_plan(10_000, 5000, 10, 10_000, F32, 264)  # 20 KB: one row
    assert p.tile_rows == 1 and p.stages == 3
    p = launch_plan(10_000, 10, 10, 10_000, BF16, 264)  # 20-byte rows
    assert p.tile_rows == 1280
    p = launch_plan(10_000, 1000, 10, 10_000, F32, 264)  # 4 KB rows
    assert p.tile_rows == 6


def test_plan_refuses_oversize_c_and_odd_dtypes():
    with pytest.raises(ValueError, match="232448 a block can hold"):
        launch_plan(10**6, 100, 20_000, 10**6, F32, 264)
    launch_plan(10**6, 100, 16_384, 10**6, F32, 264)  # Q * 8 = 128 KB fits
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch_plan(100, 4, 8, 100, torch.float16, 264)
    with pytest.raises(ValueError, match="c <= seg"):
        launch_plan(100, 4, 200, 128, F32, 264)


@pytest.mark.parametrize("D", [1, 10, 100, 1000, 8000, 40_000, 57_500])
def test_plan_runs_every_shape_the_block_kernel_took(D):
    """Every (M, D, c, block_m) within the first K7's limit, 8 (bm + Q) +
    4 D bytes of dynamic and 1,044 of static shared memory a block, plans
    in both modes (round 0's histogram shrinks to 1 KB next to a long
    q)."""
    for c in (1, 7, 128, 1000, 5000, 12_000):
        Q = 1 << (c - 1).bit_length()
        for M in (c, 50_000):
            for block_m in (128, 8192, 32_768):
                bm = block_rows(M, c, block_m)
                if 8 * (bm + Q) + 4 * D + 1044 > MAX_SMEM_BYTES:
                    continue
                for dtype in (F32, BF16):
                    cap = _h100_capacity(D, c, dtype)
                    assert cap >= H100_SMS
                    launch_plan(M, D, c, bm, dtype, cap)
                    launch_plan(M, D, c, M, dtype, cap)


# ---------------------------------------------------------------------------
# A numpy model of the kernel's grid-wide select
# ---------------------------------------------------------------------------


def _keys(scores):
    """The kernel's 64-bit keys: ordered(value) << 32 | (2^32 - 1 - id)."""
    bits = (scores.astype(np.float32) + np.float32(0)).view(np.uint32)
    bits = bits.astype(np.uint64)
    ordered = np.where(bits >> np.uint64(31), ~bits & np.uint64(0xFFFFFFFF),
                       bits | np.uint64(0x80000000))
    ids = np.arange(len(scores), dtype=np.uint64)
    return (ordered << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - ids)


def _grid_select(keys, c, ctas, gather, rng):
    """The kernel's steps 3-4 on one segment split evenly over ``ctas``:
    per-CTA digit histograms summed each round, every CTA resolving the
    same digit, until the keys at or above the resolved bin number at
    most ``gather``; then each CTA's such keys written to the gather
    slots at a base taken in an arbitrary order, sorted, the top c kept.
    Returns (the c keys descending, rounds, candidates)."""
    n = len(keys)
    parts = [keys[n * p // ctas:n * (p + 1) // ctas] for p in range(ctas)]
    prefix, mask, need = 0, 0, c
    width, shift = 10, 54  # the top 10 bits, then 8 a round
    for r in range(8):
        bins = 1 << width
        total = np.zeros(bins, dtype=np.int64)
        for part in parts:
            mine = [int(k) for k in part if int(k) & mask == prefix]
            total += np.bincount([(k >> shift) & (bins - 1) for k in mine],
                                 minlength=bins)
        above = 0
        for b in range(bins - 1, -1, -1):
            if above + total[b] >= need:
                prefix |= b << shift
                need -= above
                cand = c - need + int(total[b])
                break
            above += total[b]
        mask |= (bins - 1) << shift
        if cand <= gather or shift == 0:
            break
        width = min(8, shift)
        shift -= width
    slots = np.zeros(gather, dtype=np.uint64)
    counter = 0
    for p in rng.permutation(ctas):  # the atomic's order is arbitrary
        mine = [k for k in parts[p] if int(k) & mask >= prefix]
        slots[counter:counter + len(mine)] = mine
        counter += len(mine)
    assert c <= counter == cand <= gather
    return np.sort(slots)[::-1][:c], r + 1, cand


@pytest.mark.parametrize("order", ["ascending", "descending", "equal",
                                   "gaussian"])
@pytest.mark.parametrize("ctas", [1, 2, 7, 264])
@pytest.mark.parametrize("gather", [512, 2048])
def test_grid_select_model_equals_plain(order, ctas, gather):
    n, c = 4000, 300
    rng = np.random.default_rng(ctas)
    scores = {"ascending": np.arange(n, dtype=np.float32) / 7,
              "descending": -np.arange(n, dtype=np.float32) / 7,
              "equal": np.full(n, 0.25, dtype=np.float32),
              "gaussian": rng.standard_normal(n).astype(np.float32)}[order]
    got, rounds, cand = _grid_select(_keys(scores), c, ctas, gather, rng)
    assert 1 <= rounds <= 8
    if order == "equal":  # one bin holds every key until the index bits
        assert rounds > 4
    if order == "gaussian" and gather >= 2 * c:  # the first round's bin
        assert rounds == 1
    emb = torch.from_numpy(scores)[:, None]
    vals, idx = scored_topk_segments_plain(emb, torch.ones(1), c, n)
    want = _keys(scores)[idx[0].numpy()]
    np.testing.assert_array_equal(got, want)
    # decoded as the kernel decodes: the plain version's values
    ordered = (got >> np.uint64(32)).astype(np.uint32)
    bits = np.where(ordered >> np.uint32(31), ordered & np.uint32(0x7FFFFFFF),
                    ~ordered)
    np.testing.assert_array_equal(bits.view(np.float32), vals[0].numpy())
