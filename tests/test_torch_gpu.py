"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips without a CUDA device (the kernels have no
CPU mode).  This module imports neither JAX nor ``repro``, so it runs on a
machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Slates index for index, ``d_hist`` within rtol 3e-4 / atol 1e-5 (small,
well-separated inputs: no near-ties at these sizes).  The fused chunk
kernels K5/K6 are also held against the whole-slate kernels on the card
(the same per-column device code: equal bits) and counted at one launch
per chunk, multi-tile cooperative grids and slots at mixed progress
included.  K4 runs each step with its state on the card; K6 keeps its
ring (and, where it fits, V) in shared memory: both are held against
their plain versions, and K6 against K2 and K4 bit for bit.  K3 and K5
run several columns per thread with their loads in flight; K5 keeps V
in shared memory where it fits and meets at a per-lane barrier: K3 is
held against its plain version and K1 bit for bit (ragged M, three tile
widths, an eps-stop, exact ties across tiles), K5 in both modes against
its plain version and K1, K3 and each other bit for bit, and with lanes
at different progress.  K1 and K2 run each user on a thread-block
cluster: forced to 1, 2, 4 and 8 CTAs a user, V in shared memory or
streamed, the state (K1's Cholesky rows, K2's ring) in shared or device
memory, they are held against their plain versions
and bit for bit against K3/K5 (K1) and K4/K6 (K2), so against each
other at every cluster size; a cluster size the card cannot place is
refused before any launch.

K8 (``fm_interaction``) and K7 (``scored_topk``) are held against their
plain versions on the CPU: K8 within rtol 1e-5 / atol 2e-6 * F * D
(float32 sums of F * D unit-normal terms in another order, whose
cancellation leaves an absolute error that grows with F * D), K7 index
for index on data whose float32 scores are exact in any order (small
integers with many ties, scores ascending or descending with the row,
all equal), in blocks and global mode, its keys on chip or forced to
device memory, and within rtol / atol 1e-5 with equal index sets on
Gaussian data; its global mode is one launch with no op after it.

The paper's experiments: the card's float64 batched-slogdet naive greedy
selects the numpy float64 oracle's slate index for index; MMR and
greedy-avg on the card equal their CPU runs index for index (eager
float32 elementwise ops round alike); Figure 6's stream is one K6 launch
a chunk.
"""
import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import (
    GreedySpec,
    greedy_avg_select,
    greedy_chunk_slots,
    greedy_map_naive,
    greedy_map_chunks,
    greedy_slot_state,
    greedy_slots_init,
    mmr_select,
    state_splice,
)
from repro_torch.core.greedy_naive import greedy_map_naive_vmapped
from repro_torch.figures import fig6_streaming
from repro_torch.kernels import cuda
from repro_torch.kernels.dpp_greedy import dpp_greedy
from repro_torch.kernels.dpp_greedy import tiled
from repro_torch.kernels.dpp_greedy.dpp_greedy import (
    cluster_plan,
    dpp_greedy_resident,
    dpp_greedy_resident_plain,
    dpp_greedy_resident_windowed,
    dpp_greedy_resident_windowed_plain,
    init_gains,
)
from repro_torch.kernels.dpp_greedy.ops import _stream_tile
from repro_torch.kernels.fm_interaction import (
    fm_interaction,
    fm_interaction_ref,
)
from repro_torch.kernels.scored_topk import (
    scored_topk,
    scored_topk_blocks,
    scored_topk_blocks_plain,
    scored_topk_ref,
    scored_topk_segments,
)
from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

RTOL, ATOL = 3e-4, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _inputs(seed, B=3, D=32, M=512):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, D, M)).astype(np.float32)
    F /= np.linalg.norm(F, axis=1, keepdims=True)
    V = F * np.exp(rng.uniform(size=(B, 1, M)) * np.log(3.0)).astype(
        np.float32)
    return torch.from_numpy(V), torch.from_numpy(rng.uniform(size=(B, M))
                                                 > 0.2)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_m", [None, 128])
@pytest.mark.parametrize("window", [None, 4])
def test_kernels_match_plain(card, window, tile_m):
    V, mask = _inputs(0)
    k = 16 if window is None else 40
    want = dpp_greedy(V, k, mask, eps=1e-6, window=window, tile_m=tile_m)
    cuda.reset_launch_counts()
    got = dpp_greedy(V.cuda(), k, mask.cuda(), eps=1e-6, window=window,
                     tile_m=tile_m)
    torch.cuda.synchronize()
    assert sum(cuda.launch_counts().values()) == (1 if tile_m is None else k)
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 5])
def test_reranker_on_card_matches_cpu(card, window):
    rng = np.random.default_rng(1)
    scores = rng.uniform(size=(2, 3000)).astype(np.float32)
    feats = rng.standard_normal((3000, 24)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    cfg = DPPRerankConfig(use_kernel=True, shortlist=400, slate_size=20,
                          alpha=3.0, window=window)
    req = RerankRequest(scores=scores, feats=feats)
    got = Reranker(cfg, device="cuda").rerank(req)
    want = Reranker(cfg, device="cpu").rerank(req)
    assert got[0].is_cuda
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL, atol=ATOL)


def _stream(V, mask, k, window, chunk, tile_m=None, eps=1e-6):
    spec = GreedySpec(k=k, window=window, backend="kernel", eps=eps,
                      tile_m=tile_m)
    parts = list(greedy_map_chunks(spec, V=V, mask=mask, chunk_size=chunk))
    return (torch.cat([p.indices for p in parts], -1),
            torch.cat([p.d_hist for p in parts], -1))


@pytest.mark.gpu
@pytest.mark.parametrize("tile_m", [None, 128])
@pytest.mark.parametrize("window", [None, 4])
def test_chunk_kernels_match_plain_one_launch_per_chunk(card, window, tile_m):
    V, mask = _inputs(2)
    k, chunk = (16, 5) if window is None else (40, 7)
    want = _stream(V, mask, k, window, chunk, tile_m)
    cuda.reset_launch_counts()
    got = _stream(V.cuda(), mask.cuda(), k, window, chunk, tile_m)
    torch.cuda.synchronize()
    name = "fused_chunk_exact" if window is None else "fused_chunk_windowed"
    assert cuda.launch_counts() == {name: -(-k // chunk)}
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL, atol=ATOL)
    # the resident whole-slate kernel K1/K2 on the same inputs: the same
    # per-column device code, so the same bits
    whole = dpp_greedy(V.cuda(), k, mask.cuda(), eps=1e-6, window=window)
    assert torch.equal(got[0], whole[0])
    assert torch.equal(got[1], whole[1])


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 4])
def test_chunk_kernels_past_one_block_per_sm(card, window):
    # 200 lanes, more than the card's 132 SMs: the tile model sizes the
    # cooperative grid by the occupancy the card reports
    V, mask = _inputs(4, B=200, D=16, M=256)
    k, chunk = 12, 5
    want = _stream(V, mask, k, window, chunk)
    cuda.reset_launch_counts()
    got = _stream(V.cuda(), mask.cuda(), k, window, chunk)
    torch.cuda.synchronize()
    name = "fused_chunk_exact" if window is None else "fused_chunk_windowed"
    assert cuda.launch_counts() == {name: -(-k // chunk)}
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL, atol=ATOL)
    # 200 lanes x 8 tiles of 32 columns cannot be co-resident: refused
    # before any launch, with no fallback
    cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="wider tile_m"):
        _stream(V.cuda(), mask.cuda(), k, window, chunk, tile_m=32)
    assert cuda.launch_counts() == {}


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 4])
def test_chunk_slots_mixed_progress_on_card(card, window):
    V, mask = _inputs(3, B=4)
    k, chunk = 24, 4
    spec = GreedySpec(k=k, window=window, backend="kernel", eps=1e-6)
    runs = {}
    for dev in ("cpu", "cuda"):
        state, Vs = greedy_slots_init(spec, 4, V.shape[1], V.shape[2],
                                      device=dev)
        Vs.copy_(V)
        out = []
        for c in range(8):
            for b in range(4):
                if c == b:  # slot b joins at cycle b: t differs per lane
                    single = greedy_slot_state(spec, V[b].to(dev),
                                               mask=mask[b].to(dev))
                    state = state_splice(state, single, b)
            cuda.reset_launch_counts()
            state, sel, dh = greedy_chunk_slots(spec, state, Vs, chunk)
            if dev == "cuda":
                assert cuda.launch_counts() == {
                    "fused_chunk_exact" if window is None
                    else "fused_chunk_windowed": 1}
            out.append((sel.cpu(), dh.cpu()))
        runs[dev] = out
    for (gs, gd), (ws, wd) in zip(runs["cuda"], runs["cpu"]):
        assert torch.equal(gs, ws)
        torch.testing.assert_close(gd, wd, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("D,w,k,eps", [
    (32, 4, 40, 1e-6),  # the ring full for 36 of the 40 steps
    (3, 4, 10, 0.05),   # rank 3: an eps-stop at step 3, then latched
    (64, 40, 60, 1e-6),  # w > 32: the shared-memory eviction derivation
])
def test_k4_matches_plain(card, D, w, k, eps):
    # five tiles of 128 (the last ragged), the winner's column and the
    # window factor crossing tiles through the step-parity buffers
    V, mask = _inputs(5, B=3, D=D, M=600)
    want = tiled.dpp_greedy_tiled(V, mask, k, w, eps, 128)
    cuda.reset_launch_counts()
    got = tiled.dpp_greedy_tiled(V.cuda(), mask.cuda(), k, w, eps, 128)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"tiled_step_windowed": k}
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL, atol=ATOL)
    if D == 3:
        assert bool((want[0][:, 3:] == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,D,M,w,tile_m,vres", [
    (2, 32, 512, 4, None, True),     # one whole-M V-resident tile per lane
    (2, 100, 1000, 10, None, True),  # phase 7's split: 2 tiles of 512
    (2, 64, 2048, 4, 1024, False),   # V streams: 69 floats a column > 227 KB
    # w > 32 (the shared-memory eviction derivation) in both modes
    (2, 64, 512, 40, None, True),    # 105 floats a column: 222,912 B
    (2, 64, 2048, 40, 1024, False),
])
def test_k6_modes_match_plain_and_k2_k4_bits(card, B, D, M, w, tile_m,
                                             vres):
    V, mask = _inputs(6, B=B, D=D, M=M)
    k, chunk = 3 * w + 2, 5
    assert _stream_tile(D, M, w, True, tile_m, B,
                        torch.device("cuda"))[1] == vres
    want = _stream(V, mask, k, w, chunk, tile_m)
    cuda.reset_launch_counts()
    got = _stream(V.cuda(), mask.cuda(), k, w, chunk, tile_m)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"fused_chunk_windowed": -(-k // chunk)}
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL, atol=ATOL)
    # K2 (resident) and K4 (tiled per step) on the same inputs: the same
    # per-column arithmetic, so the same bits
    cuda.reset_launch_counts()
    k2 = dpp_greedy(V.cuda(), k, mask.cuda(), eps=1e-6, window=w)
    k4 = dpp_greedy(V.cuda(), k, mask.cuda(), eps=1e-6, window=w,
                    tile_m=256)
    assert cuda.launch_counts() == {"dpp_greedy_resident_windowed": 1,
                                    "tiled_step_windowed": k}
    for whole in (k2, k4):
        assert torch.equal(got[0], whole[0])
        assert (got[1] - whole[1]).abs().max().item() == 0.0


@pytest.mark.gpu
def test_shared_memory_limit_set_once_only_grows(card):
    # each kernel's dynamic shared-memory limit is raised once per size,
    # never lowered: a large K1 block, a small one, the large one again
    sizes = (20000, 512, 20000)
    for M in sizes:
        V, mask = _inputs(11, B=2, D=16, M=M)
        cuda.reset_launch_counts()
        got = dpp_greedy(V.cuda(), 8, mask.cuda(), eps=1e-6)
        assert cuda.launch_counts() == {"dpp_greedy_resident": 1}
        want = dpp_greedy(V, 8, mask, eps=1e-6)
        assert torch.equal(got[0].cpu(), want[0])


def _k3_by_wrapper(V, mask, k, eps, tile_m):
    """The whole-slate K3 loop through the public per-step wrapper
    ``tiled_step_exact`` (its own checks every launch)."""
    B, D, M = V.shape
    ar = torch.arange(B, device=V.device)
    d2 = init_gains(V, mask)
    C = torch.zeros((B, k, M), dtype=torch.float32, device=V.device)
    keys = torch.zeros((k + 1, B), dtype=torch.int64, device=V.device)
    j0 = torch.argmax(d2, dim=1)
    keys[0] = tiled.pack_key(d2[ar, j0], j0)
    flags = torch.zeros((k + 1, B), dtype=torch.int32, device=V.device)
    sel = torch.empty((B, k), dtype=torch.int32, device=V.device)
    dh = torch.empty((B, k), dtype=torch.float32, device=V.device)
    for t in range(k):
        tiled.tiled_step_exact(V, C, d2, keys, flags, sel, dh, t, eps, tile_m)
    return sel, dh


@pytest.mark.gpu
@pytest.mark.parametrize("D,M,k,eps,tile_m,ties", [
    (32, 777, 20, 1e-6, 128, False),    # ragged: 7 tiles, the last of 9
    (32, 777, 20, 1e-6, 256, False),
    (32, 777, 20, 1e-6, 1024, False),   # one ragged tile
    (16, 65539, 12, 1e-6, 1024, False),  # 64 tiles and 3 columns
    (3, 777, 10, 0.05, 128, False),     # rank 3: an eps-stop at step 3
    (32, 777, 20, 1e-6, 128, True),     # exact ties across tiles
    (32, 777, 20, 1e-6, 1024, True),    # and within one
])
def test_k3_matches_plain_and_k1_bits(card, D, M, k, eps, tile_m, ties):
    V, mask = _inputs(8, B=2, D=D, M=M)
    if ties:
        # columns 600..699 copy 0..99, boosted so they lead: equal bits,
        # equal gains at every step, and the lower index must win
        V[:, :, :100] *= 3.0
        V[:, :, 600:700] = V[:, :, :100]
        mask[:, 600:700] = mask[:, :100]
    want = tiled.dpp_greedy_tiled(V, mask, k, None, eps, tile_m)
    cuda.reset_launch_counts()
    got = tiled.dpp_greedy_tiled(V.cuda(), mask.cuda(), k, None, eps, tile_m)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"tiled_step_exact": k}
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL, atol=ATOL)
    if D == 3:
        assert bool((want[0][:, 3:] == -1).all())
    if ties:
        # a copy is picked only after its original, which ties it and
        # has the lower index
        for lane in got[0].cpu().tolist():
            assert any(0 <= p < 100 for p in lane)
            for q, p in enumerate(lane):
                if 600 <= p < 700:
                    assert p - 600 in lane[:q]
    # the public per-step wrapper gives the same bits as the lean loop
    by_wrapper = _k3_by_wrapper(V.cuda(), mask.cuda(), k, eps, tile_m)
    assert torch.equal(by_wrapper[0], got[0])
    assert torch.equal(by_wrapper[1], got[1])
    # K1 (resident) on the same inputs where one block holds the lane,
    # else K5 streamed: the same per-column arithmetic, the same bits
    if M < 50000:
        cuda.reset_launch_counts()
        whole = dpp_greedy(V.cuda(), k, mask.cuda(), eps=eps)
        assert cuda.launch_counts() == {"dpp_greedy_resident": 1}
    else:
        whole = _stream(V.cuda(), mask.cuda(), k, None, 5, tile_m, eps)
    assert torch.equal(got[0], whole[0])
    assert (got[1] - whole[1]).abs().max().item() == 0.0


def _cluster_inputs(B, D, M, seed, ties, masked):
    V, mask = _inputs(seed, B=B, D=D, M=M)
    if not masked:
        mask[:] = True
    if ties:
        # columns 600..699 copy 0..99, boosted so they lead: equal bits and
        # equal gains in CTAs of different ranks; the lower index must win
        V[:, :, :100] *= 3.0
        V[:, :, 600:700] = V[:, :, :100]
        mask[:, 600:700] = mask[:, :100]
    return V.cuda(), mask.cuda()


# (B, D, M, k, eps, ties, masked, the policy's (V, Cholesky rows)
# residency at 1, 2, 4 and 8 CTAs a user)
_K1_CASES = {
    "single-phase1": (1, 100, 1000, 50, 1e-6, False, False, "01 10 11 11"),
    "ragged-mask": (3, 32, 777, 20, 1e-6, False, True, "11 11 11 11"),
    "batch64": (64, 100, 1000, 24, 1e-6, False, False, "01 10 11 11"),
    "waves200": (200, 16, 512, 12, 1e-6, False, True, "11 11 11 11"),
    "v-streamed": (2, 100, 20000, 12, 1e-6, False, False, "00 00 00 01"),
    "eps-stop": (2, 3, 777, 10, 0.05, False, True, "11 11 11 11"),
    "ties": (2, 32, 777, 20, 1e-6, True, True, "11 11 11 11"),
}


def _layouts(plan):
    """The policy's layout and, where it keeps the state (K1's Cholesky
    rows, K2's ring) in shared memory, the same with the state in device
    memory."""
    return [plan] + ([plan._replace(state_resident=False)]
                     if plan.state_resident else [])


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(_K1_CASES))
def test_k1_clusters_match_plain_and_k3_k5_bits(card, case, s):
    B, D, M, k, eps, ties, masked, modes = _K1_CASES[case]
    V, mask = _cluster_inputs(B, D, M, 12, ties, masked)
    plan = cluster_plan(D, M, k, False, B, V.device, s)
    mode = modes.split()[[1, 2, 4, 8].index(s)]
    assert plan == (s, mode[0] == "1", mode[1] == "1")
    d2 = init_gains(V, mask)
    want = dpp_greedy_resident_plain(V, d2, k, eps)
    # K3 (tiled per step) and K5 (fused chunks): the same per-column
    # arithmetic and argmax rule, so the same bits at every cluster size
    k3 = tiled.dpp_greedy_tiled(V, mask, k, None, eps, 128)
    k5 = _stream(V, mask, k, None, 5, None, eps)
    for layout in _layouts(plan):
        cuda.reset_launch_counts()
        got = dpp_greedy_resident(V, d2, k, eps, plan=layout)
        torch.cuda.synchronize()
        assert cuda.launch_counts() == {"dpp_greedy_resident": 1}
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
        if eps == 0.05:
            assert bool((got[0][:, 3:] == -1).all())
            assert bool((got[1][:, 3:] == 0).all())
        if ties:
            for lane in got[0].cpu().tolist():
                assert any(0 <= p < 100 for p in lane)
                for q, p in enumerate(lane):
                    if 600 <= p < 700:
                        assert p - 600 in lane[:q]
        for whole in (k3, k5):
            assert torch.equal(got[0], whole[0])
            assert (got[1] - whole[1]).abs().max().item() == 0.0


# (B, D, M, w, k, eps, ties, masked, the fewest CTAs at which V and the
# ring are resident, the fewest at which the ring is with V streamed)
_K2_CASES = {
    "single-phase2": (1, 100, 1000, 10, 40, 1e-6, False, False, 2, 1),
    "ragged-mask": (3, 32, 777, 4, 14, 1e-6, False, True, 1, 1),
    "batch64": (64, 100, 1000, 10, 32, 1e-6, False, False, 2, 1),
    "waves200": (200, 16, 512, 4, 14, 1e-6, False, True, 1, 1),
    "v-streamed": (2, 100, 20000, 10, 24, 1e-6, False, False, None, 4),
    "w40": (2, 64, 512, 40, 122, 1e-6, False, True, 1, 1),
    "eps-stop": (2, 3, 777, 4, 10, 0.05, False, True, 1, 1),
    "ties": (2, 32, 777, 4, 20, 1e-6, True, True, 1, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(_K2_CASES))
def test_k2_clusters_match_plain_and_k4_k6_bits(card, case, s):
    B, D, M, w, k, eps, ties, masked, vres_from, ring_from = _K2_CASES[case]
    V, mask = _cluster_inputs(B, D, M, 13, ties, masked)
    plan = cluster_plan(D, M, w, True, B, V.device, s)
    assert plan.s == s
    assert plan.v_resident == (vres_from is not None and s >= vres_from)
    assert plan.state_resident == (s >= ring_from)
    d2 = init_gains(V, mask)
    want = dpp_greedy_resident_windowed_plain(V, d2, k, w, eps)
    # K4 (tiled per step) and K6 (fused chunks): the same bits
    k4 = tiled.dpp_greedy_tiled(V, mask, k, w, eps, 128)
    k6 = _stream(V, mask, k, w, 5, None, eps)
    for layout in _layouts(plan):
        cuda.reset_launch_counts()
        got = dpp_greedy_resident_windowed(V, d2, k, w, eps, plan=layout)
        torch.cuda.synchronize()
        assert cuda.launch_counts() == {"dpp_greedy_resident_windowed": 1}
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)
        if eps == 0.05:
            assert bool((got[0][:, 3:] == -1).all())
        if ties:
            assert bool((got[0][:, 0] < 100).all())
        for whole in (k4, k6):
            assert torch.equal(got[0], whole[0])
            assert (got[1] - whole[1]).abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 4])
def test_resident_cluster_the_card_cannot_place_raises(card, window):
    # 16 CTAs a cluster need the non-portable cluster attribute, which the
    # kernels do not set: the card places none, and the call raises before
    # any launch instead of running at another cluster size
    V, mask = _inputs(14, B=2, D=16, M=512)
    V, mask = V.cuda(), mask.cuda()
    d2 = init_gains(V, mask)
    cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="no resident cluster layout"):
        plan = cluster_plan(16, 512, 8 if window is None else window,
                            window is not None, 2, V.device, 16)
        if window is None:
            dpp_greedy_resident(V, d2, 8, 1e-6, plan=plan)
        else:
            dpp_greedy_resident_windowed(V, d2, 8, window, 1e-6, plan=plan)
    assert cuda.launch_counts() == {}


def _slots(spec, V, schedule, cycles, chunk, dev):
    """Per-cycle (sel, dh) of a slot batch on ``dev``: slot b joins
    before cycle ``schedule[b]``."""
    S, D, M = V.shape
    state, Vs = greedy_slots_init(spec, S, D, M, device=dev)
    Vs.copy_(V)
    out = []
    for c in range(cycles):
        for b in range(S):
            if schedule[b] == c:
                state = state_splice(state, greedy_slot_state(
                    spec, V[b].to(dev)), b)
        cuda.reset_launch_counts()
        state, sel, dh = greedy_chunk_slots(spec, state, Vs, chunk)
        if dev == "cuda":
            assert cuda.launch_counts() == {"fused_chunk_exact": 1}
        out.append((sel.cpu(), dh.cpu()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 64])
def test_k5_modes_match_plain_and_k1_k3_bits(card, B):
    # phase 6 and 9's shape: D = 100, C = 1000, V in shared memory over
    # two tiles of 512 per lane; tile_m = 1024 streams it instead (one
    # tile per lane: 1024 columns of V do not fit a block)
    D, M, k, chunk = 100, 1000, 24, 5
    V, mask = _inputs(7, B=B, D=D, M=M)
    assert _stream_tile(D, M, k, False, None, B, torch.device("cuda")) \
        == (512, True)
    assert _stream_tile(D, M, k, False, 1024, B, torch.device("cuda")) \
        == (1000, False)
    want = _stream(V, mask, k, None, chunk)
    runs = []
    for tile_m in (None, 1024):
        cuda.reset_launch_counts()
        got = _stream(V.cuda(), mask.cuda(), k, None, chunk, tile_m)
        torch.cuda.synchronize()
        assert cuda.launch_counts() == {"fused_chunk_exact": -(-k // chunk)}
        assert torch.equal(got[0].cpu(), want[0])
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=RTOL,
                                   atol=ATOL)
        runs.append(got)
    # K1 (resident) and K3 (tiled per step) on the same inputs, and the
    # two K5 modes against each other: the same bits
    cuda.reset_launch_counts()
    k1 = dpp_greedy(V.cuda(), k, mask.cuda(), eps=1e-6)
    k3 = dpp_greedy(V.cuda(), k, mask.cuda(), eps=1e-6, tile_m=256)
    assert cuda.launch_counts() == {"dpp_greedy_resident": 1,
                                    "tiled_step_exact": k}
    for whole in (runs[1], k1, k3):
        assert torch.equal(runs[0][0], whole[0])
        assert (runs[0][1] - whole[1]).abs().max().item() == 0.0


@pytest.mark.gpu
def test_k5_lanes_at_different_progress(card):
    # six slots of two V-resident tiles each, joining one cycle apart, one
    # of rank 3 that eps-stops after three picks while the others run on:
    # every lane meets only its own two blocks at each barrier
    S, D, M, k, chunk = 6, 100, 1000, 16, 4
    V, _ = _inputs(9, B=S, D=D, M=M)
    rng = np.random.default_rng(10)
    V[3] = torch.from_numpy((rng.standard_normal((D, 3)) @
                             rng.standard_normal((3, M))).astype(np.float32))
    spec = GreedySpec(k=k, backend="kernel", eps=0.05)
    assert _stream_tile(D, M, k, False, None, S, torch.device("cuda")) \
        == (512, True)
    schedule, cycles = list(range(S)), S - 1 + -(-k // chunk)
    got = _slots(spec, V.cuda(), schedule, cycles, chunk, "cuda")
    want = _slots(spec, V, schedule, cycles, chunk, "cpu")
    for (gs, gd), (ws, wd) in zip(got, want):
        assert torch.equal(gs, ws)
        torch.testing.assert_close(gd, wd, rtol=RTOL, atol=ATOL)
    sel = torch.cat([x[0] for x in got], 1)
    dh = torch.cat([x[1] for x in got], 1)
    whole = dpp_greedy(V.cuda(), k, eps=0.05)
    for b in range(S):
        cols = slice(schedule[b] * chunk, schedule[b] * chunk + k)
        assert torch.equal(sel[b, cols], whole[0][b].cpu())
        assert (dh[b, cols] - whole[1][b].cpu()).abs().max().item() == 0.0
    assert bool((whole[0][3, 3:] == -1).all())
    assert bool((whole[0][:3] >= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("N,F,D,block_b", [
    (1, 1, 1, 128), (130, 39, 10, 128), (1000, 26, 32, 32), (257, 4, 8, 64),
    (3, 400, 130, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fm_interaction_kernel_matches_plain(card, N, F, D, block_b, dtype):
    rng = np.random.default_rng(N + F + D)
    x = torch.from_numpy(rng.normal(size=(N, F, D)).astype(np.float32))
    x = x.to(dtype)
    want = fm_interaction_ref(x)
    cuda.reset_launch_counts()
    got = fm_interaction(x.cuda(), block_b=block_b)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"fm_interaction": 1}
    assert got.dtype == torch.float32 and got.shape == (N,)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                               atol=2e-6 * F * D)


@pytest.mark.gpu
def test_fm_interaction_kernel_refuses_grad(card):
    x = torch.randn(4, 3, 2, device="cuda", requires_grad=True)
    cuda.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        fm_interaction(x)
    assert cuda.launch_counts() == {}


def _topk_data(kind, M, D, seed):
    """(emb, q) float32 on the CPU whose float32 scores are exact in any
    summation order and in bf16: small integers ("ints"), the row index
    ("ascending", "descending": scores i or -i; in bf16 they tie in runs
    past 256) or all equal."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-3, 4, size=(M, D)).astype(np.float32)
    q = rng.integers(-3, 4, size=(D,)).astype(np.float32)
    if kind in ("ascending", "descending"):
        q[:] = 0.0
        q[0] = 1.0
        e[:, 0] = np.arange(M) * (1.0 if kind == "ascending" else -1.0)
    elif kind == "equal":
        e[:], q[:] = 1.0, 1.0
    return torch.from_numpy(e), torch.from_numpy(q)


@pytest.fixture(params=["chip", "device"], ids=["keys-on-chip",
                                                "keys-in-device-memory"])
def keys_at(request, monkeypatch):
    """Run K7 with the plan's keys on chip, or forced to device memory."""
    if request.param == "device":
        mod = importlib.import_module(
            "repro_torch.kernels.scored_topk.scored_topk")
        monkeypatch.setattr(mod, "KEYS_SMEM_BYTES", 0)
    return request.param


@pytest.mark.gpu
@pytest.mark.parametrize("M,D,c,block_m", [
    (1000, 16, 8, 256), (4097, 16, 128, 1024), (130, 64, 128, 128),
    (1024, 8, 256, 256), (100_003, 10, 128, 8192), (3000, 100, 1000, 8192),
    (3000, 16, 1, 8192), (1000, 16, 1000, 8192), (20, 100, 20, 8192)])
@pytest.mark.parametrize("kind", ["ints", "ascending", "descending",
                                  "equal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scored_topk_kernel_matches_plain_exact(card, keys_at, M, D, c,
                                                block_m, kind, dtype):
    """Exact scores (:func:`_topk_data`): the block survivors and the
    global top-c equal the plain versions index for index, ragged edges,
    c = 1, c = M, M below one ring tile, ties across CTAs and the keys on
    chip or in device memory included."""
    e, q = _topk_data(kind, M, D, M + c)
    e, q = e.to(dtype), q.to(dtype)
    ge, gq = e.cuda(), q.cuda()
    bv, bi = scored_topk_blocks(ge, gq, c, block_m)
    pv, pi = scored_topk_blocks_plain(e, q, c, block_m)
    torch.cuda.synchronize()
    assert torch.equal(bi.cpu(), pi) and torch.equal(bv.cpu(), pv)
    cuda.reset_launch_counts()
    vals, idx = scored_topk(ge, gq, c=c, block_m=block_m)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"scored_topk": 1}
    rv, ri = scored_topk_ref(e, q, c)
    assert torch.equal(idx.cpu(), ri) and torch.equal(vals.cpu(), rv)
    sv, si = scored_topk_segments(ge, gq, c, M)
    assert torch.equal(si[0].cpu(), ri) and torch.equal(sv[0].cpu(), rv)
    assert bool((idx < M).all())


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["random", "ascending"])
def test_scored_topk_kernel_gaussian(card, order):
    rng = np.random.default_rng(11)
    e = torch.from_numpy(rng.normal(size=(50_000, 64)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    if order == "ascending":  # scores ascend with the row index
        e = e[torch.argsort(e @ q)].contiguous()
    vals, idx = scored_topk(e.cuda(), q.cuda(), c=200, block_m=4096)
    rv, ri = scored_topk_ref(e, q, 200)
    torch.testing.assert_close(vals.cpu(), rv, rtol=1e-5, atol=1e-5)
    assert set(idx.cpu().tolist()) == set(ri.tolist())
    bv, bi = scored_topk_blocks(e.cuda(), q.cuda(), 200, 4096)
    pv, pi = scored_topk_blocks_plain(e, q, 200, 4096)
    torch.testing.assert_close(bv.cpu(), pv, rtol=1e-5, atol=1e-5)
    for r in range(pi.shape[0]):
        assert set(bi[r].cpu().tolist()) == set(pi[r].tolist())


class _OpsAfterLaunch(TorchDispatchMode):
    """Each aten op dispatched, with K7's launch count at that moment."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((str(func),
                         cuda.launch_counts().get("scored_topk", 0)))
        return func(*args, **(kwargs or {}))


@pytest.mark.gpu
@pytest.mark.parametrize("M,c", [(200_000, 1000), (4096, 16)])
def test_scored_topk_global_is_one_launch_with_nothing_after(card, M, c):
    e = torch.randn(M, 32, device="cuda")
    q = torch.randn(32, device="cuda")
    scored_topk(e, q, c=c)  # builds, plans and sizes once
    cuda.reset_launch_counts()
    with _OpsAfterLaunch() as log:
        vals, idx = scored_topk(e, q, c=c)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"scored_topk": 1}
    after = [op for op, n in log.ops if n >= 1]
    assert not after, f"aten ops after the launch: {after}"
    assert vals.shape == (c,) and idx.shape == (c,)


@pytest.mark.gpu
def test_scored_topk_kernel_refuses_oversized_blocks(card):
    """The kernel's shared memory follows from c (the final sort of Q
    keys) and D, no longer from block_m: an oversize c is refused before
    any launch, a block_m of any size runs."""
    e, q = torch.zeros(40_000, 8, device="cuda"), torch.zeros(8, device="cuda")
    cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        scored_topk_blocks(e, q, 20_000)
    with pytest.raises(ValueError, match="shared memory"):
        scored_topk(e, q, c=20_000)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        scored_topk_blocks(e.half(), q.half(), 16)
    assert cuda.launch_counts() == {}
    vals, idx = scored_topk_blocks(e, q, 16, 32768)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"scored_topk": 1}
    first = torch.arange(16, dtype=torch.int32)
    assert idx.shape == (2, 16) and torch.equal(idx.cpu(), torch.stack(
        [first, first + 32768]))


# ---------------------------------------------------------------------------
# The paper's experiments on the card: the naive determinant greedy, the
# reference diversifiers and the streaming figure
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_naive_slogdet_on_card_matches_numpy_float64(card, seed):
    """The card's batched-slogdet naive greedy in float64 selects the
    numpy float64 determinant greedy's slate index for index (small,
    well-separated inputs)."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((40, 300))
    F /= np.linalg.norm(F, axis=0, keepdims=True)
    r = rng.uniform(0.5, 1.5, size=300)
    L = (r[:, None] * (F.T @ F)) * r[None, :]
    want, _ = greedy_map_naive(L, 15)
    got = greedy_map_naive_vmapped(torch.from_numpy(L).cuda(), 15)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("theta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("fn", [mmr_select, greedy_avg_select])
def test_selectors_on_card_match_cpu(card, fn, theta, masked):
    """MMR and greedy-avg are eager float32 elementwise ops, rounded the
    same on the card and the CPU: the slates are equal index for index,
    the tail past a mask with fewer than k items (index 0) included."""
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.uniform(size=400).astype(np.float32))
    F = rng.standard_normal((16, 400)).astype(np.float32)
    F /= np.linalg.norm(F, axis=0, keepdims=True)
    S = torch.from_numpy(F.T @ F)
    mask = None
    if masked:
        mask = torch.zeros(400, dtype=torch.bool)
        mask[torch.from_numpy(rng.choice(400, 12, replace=False))] = True
    want = fn(r, S, 20, theta, mask)
    got = fn(r.cuda(), S.cuda(), 20, theta,
             None if mask is None else mask.cuda())
    assert got.is_cuda
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_fig6_stream_is_one_k6_launch_per_chunk(card):
    rows = fig6_streaming.run(2048, 32, 64, 8, 8, trials=1, device="cuda")
    kernel = {r["name"]: r for r in rows}["kernel"]
    assert kernel["fused_calls_per_chunk"] == 1.0
    assert all(r["parity"] == "ok" for r in rows)
