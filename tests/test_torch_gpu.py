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
cancellation leaves an absolute error that grows with F * D), K8's
backward within rtol 1e-5 / atol 1e-6 * F (one bfloat16 ulp in
bfloat16), one launch each through autograd, and a reduced DeepFM
training step on the card against the CPU; K7 index
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

The continuous-batching router: heterogeneous requests (pools narrower
and wider than the bucket, masks) on K5 and K6 equal their per-request
rerank, one launch a pump; the ``stopped`` flags a pump decides on are
chunk N's, copied to pinned memory before chunk N+1, the evictions and
the admissions update the state's flags in place; and ``slots`` past
the card's co-residency are refused, naming the largest that fits.

Sessions: every ``next_chunk`` of a live session is one K6 launch and a
stopped session's none; a session's first chunks equal the card's K2
rerank bit for bit, and every chunk (after ``extend`` and ``rescore``
too) equals the same session on K6's plain version; an evicted session
rebuilds on the card and keeps matching a control that was never
evicted; a session's launcher launches on the stream current at each
call, not the one it was built on.

The candidate-sharded path on a one-rank group: the update entries
against their plain versions (four lanes at their own step counters,
one stopped, an exact one at the state's k rows) and K3/K4; its
stream's chunks (and ``Reranker.stream`` on a card mesh) against the
whole sharded slate bit for bit, one update launcher a stream and one
launch a step; the router on a card mesh against the per-request
sharded rerank bit for bit, ``chunk`` update launches a pump.

The LM family: K1 at an LM's width (D = 2560, qwen1.5-4b's d_model; M =
64, k = 10, the LM-embedded rerank's shape) against its plain version,
one launch; a short float32 prefill and decode on the card against the
card's full forward (rtol / atol 3e-3, a window-8 ring that wraps) and
against the same weights on the CPU (rtol 1e-4 / atol 1e-5).

Measured tile choice: a smoke sweep on the card into a temporary cache
yields entries that ``lookup_tile`` hits, and ``tile_m="auto"`` on a
cache holding another tile than the model's gives the model default's
slates bit for bit on K3-K6, through the kernels it names.
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
    greedy_map,
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
    fm_interaction_bwd_kernel,
    fm_interaction_bwd_ref,
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
    (3, 400, 130, 128), (3, 1, 29055, 128)])
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
@pytest.mark.parametrize("N,F,D,block_b", [
    (1, 1, 1, 128), (130, 39, 10, 128), (65_539, 39, 10, 128),
    (1000, 26, 32, 32), (257, 4, 8, 64), (3, 400, 130, 128),
    (3, 1, 29055, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fm_interaction_bwd_kernel_matches_plain(card, N, F, D, block_b,
                                                 dtype):
    """K8's backward against its plain version: float32 within rtol 1e-5
    / atol 1e-6 * F (a sum of F terms in another order, times g);
    bfloat16 within one bfloat16 ulp (each rounds a float32 gradient
    once).  Through autograd, one forward and one backward launch."""
    rng = np.random.default_rng(N + F + D)
    x = torch.from_numpy(rng.normal(size=(N, F, D)).astype(np.float32))
    x = x.to(dtype)
    g = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    want = fm_interaction_bwd_ref(x, g)
    cuda.reset_launch_counts()
    got = fm_interaction_bwd_kernel(x.cuda(), g.cuda(), block_b=block_b)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"fm_interaction_bwd": 1}
    assert got.dtype == dtype and got.shape == (N, F, D)
    rtol, atol = ((1e-5, 1e-6 * F) if dtype == torch.float32
                  else (2 ** -7, 1e-6 * F))
    torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=atol)
    xg = x.cuda().requires_grad_(True)
    cuda.reset_launch_counts()
    fm_interaction(xg, block_b=block_b).backward(g.cuda())
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"fm_interaction": 1,
                                    "fm_interaction_bwd": 1}
    assert torch.equal(xg.grad, got)


@pytest.mark.gpu
def test_fm_interaction_shape_only_route_is_for_fake_tensors_only(card):
    """A real CUDA tensor launches K8 (and its backward); a fake CUDA
    tensor of the same shape takes the shape-only route and launches
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.fm_interaction.fm_interaction import shape_only

    x = torch.randn(300, 39, 10, device="cuda")
    assert not shape_only(x)
    cuda.reset_launch_counts()
    got = fm_interaction(x)
    fm_interaction_bwd_kernel(x, torch.ones(300, device="cuda"))
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"fm_interaction": 1,
                                    "fm_interaction_bwd": 1}
    torch.testing.assert_close(got.cpu(), fm_interaction_ref(x.cpu()),
                               rtol=1e-5, atol=2e-6 * 390)
    cuda.reset_launch_counts()
    with FakeTensorMode():
        fx = torch.empty(300, 39, 10, device="cuda")
        assert shape_only(fx)
        assert fm_interaction(fx).shape == (300,)
    assert cuda.launch_counts() == {}


@pytest.mark.gpu
@pytest.mark.parametrize("offset,N", [(1, 4099), (2, 4099), (3, 4099),
                                      (0, 8191), (0, 100), (3, 7)],
                         ids=["offset1", "offset2", "offset3", "ragged",
                              "below_grid", "below_grid_offset3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fm_interaction_kernels_on_views_and_short_grids(card, offset, N,
                                                         dtype):
    """K8 and its backward at DeepFM's F = 39, D = 10 on a view that starts
    ``offset`` elements into its storage (every tile's span then starts
    off 16 bytes: its ends come by plain loads, its interior by the bulk
    copy), a ragged N (the last tile short) and N below the persistent
    grid (fewer tiles than co-resident blocks): against the plain
    versions (forward rtol 1e-5 / atol 2e-6 * F * D; backward rtol 1e-5 /
    atol 1e-6 * F, one bfloat16 ulp in bfloat16) and bit for bit against
    the same examples in a fresh, aligned tensor."""
    F, D = 39, 10
    rng = np.random.default_rng(offset * 7 + N)
    flat = torch.from_numpy(rng.normal(size=(offset + N * F * D,)).astype(
        np.float32)).to(dtype).cuda()
    x = flat[offset:].view(N, F, D)
    assert x.is_contiguous() and x.storage_offset() == offset
    g = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)).cuda()
    aligned = x.clone()
    assert aligned.data_ptr() % 16 == 0
    cuda.reset_launch_counts()
    y = fm_interaction(x)
    grad = fm_interaction_bwd_kernel(x, g)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"fm_interaction": 1,
                                    "fm_interaction_bwd": 1}
    torch.testing.assert_close(y.cpu(), fm_interaction_ref(x.cpu()),
                               rtol=1e-5, atol=2e-6 * F * D)
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(grad.cpu(),
                               fm_interaction_bwd_ref(x.cpu(), g.cpu()),
                               rtol=rtol, atol=1e-6 * F)
    assert torch.equal(y, fm_interaction(aligned))
    assert torch.equal(grad, fm_interaction_bwd_kernel(aligned, g))


@pytest.mark.gpu
def test_deepfm_train_step_on_the_card_matches_the_cpu(card):
    """Two ``make_step`` steps of reduced DeepFM on the card against the
    same init and batches on the CPU: loss and grad_norm within rtol
    1e-4, the parameters within rtol 1e-4 / atol 1e-5; one K8 forward
    and one K8 backward launch a step."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batches
    from repro_torch.launch.train import make_step
    from repro_torch.models import recsys
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_arch("deepfm").reduced()
    step = make_step(lambda m, b: recsys.bce_loss(m, b, cfg),
                     AdamWConfig(lr=1e-3), 1, 4)
    model = recsys.init_params(torch.Generator().manual_seed(0), cfg)
    stream = recsys_batches(cfg.vocab_sizes, 256)
    batches = [next(stream) for _ in range(2)]
    runs = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        opt = adamw_init(dict(m.named_parameters()))
        out = []
        for b in batches:
            batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            cuda.reset_launch_counts()
            m, opt, _, met = step(m, opt, None, batch)
            out.append((float(met["loss"]), float(met["grad_norm"]),
                        cuda.launch_counts()))
        runs[dev] = (out, {n: p.detach().cpu()
                           for n, p in m.named_parameters()})
    for (l_cpu, n_cpu, c_cpu), (l, n, c) in zip(runs["cpu"][0],
                                                runs["cuda"][0]):
        assert c_cpu == {} and c == {"fm_interaction": 1,
                                     "fm_interaction_bwd": 1}
        assert abs(l - l_cpu) <= 1e-4 * abs(l_cpu)
        assert abs(n - n_cpu) <= 1e-4 * abs(n_cpu)
    for name, p in runs["cuda"][1].items():
        torch.testing.assert_close(p, runs["cpu"][1][name], rtol=1e-4,
                                   atol=1e-5)


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


# ---------------------------------------------------------------------------
# The continuous-batching router on K5 / K6
# ---------------------------------------------------------------------------


def _router_requests(seed, n, D, bucket):
    """Heterogeneous single requests: pools narrower and wider than the
    bucket, every third with a seen mask."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        M = int(rng.integers(bucket // 2, 3 * bucket))
        feats = rng.standard_normal((M, D)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        mask = rng.uniform(size=M) > 0.1 if i % 3 == 2 else None
        reqs.append(RerankRequest(
            scores=rng.uniform(size=M).astype(np.float32), feats=feats,
            mask=mask, slate_size=int(rng.integers(4, 13)), rid=i))
    return reqs


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 4])
def test_router_on_card_matches_per_request_rerank(card, window):
    from repro_torch.serving import RouterConfig

    cap, chunk, slots, bucket = 12, 4, 4, 256
    cfg = DPPRerankConfig(use_kernel=True, shortlist=bucket, slate_size=cap,
                          alpha=3.0, window=window, eps=1e-6)
    rr = Reranker(cfg, router_config=RouterConfig(
        slots=slots, chunk_size=chunk, max_candidates=bucket), device="cuda")
    reqs = _router_requests(7, 10, 32, bucket)
    want = [tuple(x.cpu() for x in rr.rerank(r)) for r in reqs]
    cuda.reset_launch_counts()
    handles = [rr.submit(r) for r in reqs]
    rr.router.drain()
    kernel = "fused_chunk_exact" if window is None else \
        "fused_chunk_windowed"
    assert cuda.launch_counts() == {kernel: rr.router.stats.chunks_launched}
    for h, (ei, ed) in zip(handles, want):
        gi, gd = h.result()
        assert torch.equal(torch.from_numpy(gi), ei)
        torch.testing.assert_close(torch.from_numpy(gd), ed, rtol=RTOL,
                                   atol=ATOL)
    assert rr.router.stats.completed == len(reqs)


@pytest.mark.gpu
def test_router_delivers_stopped_flags_from_before_the_next_chunk(card):
    """The pinned copy of chunk N's ``stopped`` is what chunk N left,
    though chunk N+1, the evictions and the admissions update the
    state's flags in place before it is read."""
    from repro_torch.serving import RouterConfig

    rng = np.random.default_rng(11)
    cfg = DPPRerankConfig(use_kernel=True, shortlist=64, slate_size=16,
                          alpha=3.0, eps=0.05)
    rr = Reranker(cfg, router_config=RouterConfig(
        slots=3, chunk_size=2, max_candidates=64), device="cuda")
    for i in range(9):  # ranks 1..9: lanes stop at different chunks
        f = rng.standard_normal((64, 12)).astype(np.float32)
        f[:, 1 + i:] = 0.0
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        rr.submit(RerankRequest(scores=rng.uniform(size=64).astype(
            np.float32), feats=f))
    r, changed = rr.router, 0
    r.pump()
    while r._inflight is not None:
        launched = r._inflight
        torch.cuda.synchronize()
        left = r._state.stopped.cpu().clone()  # what chunk N left
        r.pump()  # evict, admit, launch chunk N+1
        torch.cuda.synchronize()
        assert torch.equal(launched.stopped, left)
        changed += int(not torch.equal(r._state.stopped.cpu(), left))
    assert changed > 0  # the state's own flags did move under the copy
    assert r.stats.completed == 9 and r.stats.eps_stopped > 0


@pytest.mark.gpu
def test_router_refuses_slots_past_the_card_co_residency(card):
    from repro_torch.serving import RouterConfig
    from repro_torch.serving.router import check_slots
    from repro_torch.kernels.dpp_greedy.tiled import chunk_capacity

    D, bucket, k = 100, 1000, 50
    cfg = DPPRerankConfig(use_kernel=True, shortlist=bucket, slate_size=k,
                          alpha=3.0)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2000, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    req = RerankRequest(scores=rng.uniform(size=2000).astype(np.float32),
                        feats=feats)
    rr = Reranker(cfg, router_config=RouterConfig(
        slots=4096, chunk_size=8, max_candidates=bucket), device="cuda")
    with pytest.raises(ValueError, match="largest slots that fits is") as e:
        rr.submit(req)
    largest = int(str(e.value).rsplit(" ", 1)[1])
    assert 1 <= largest < 4096 and not rr.router._queue
    capacity = lambda smem: chunk_capacity(False, smem, "cuda")  # noqa: E731
    with pytest.raises(ValueError):
        check_slots(largest + 1, D, bucket, k, False, None, capacity)
    ok = Reranker(cfg, router_config=RouterConfig(
        slots=largest, chunk_size=8, max_candidates=bucket), device="cuda")
    cuda.reset_launch_counts()
    ids, _ = ok.submit(req).result()
    assert cuda.launch_counts()["fused_chunk_exact"] >= 1
    assert torch.equal(torch.from_numpy(ids), ok.rerank(req)[0].cpu())


def _session_feed(seed=3, M=600, D=16):
    from repro_torch.serving import RerankRequest

    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((M, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return RerankRequest(scores=rng.uniform(size=M).astype(np.float32),
                         feats=feats)


def _session_verbs(rr, req):
    """Three scrolls, then twice an extend, a scroll, a rescore and a
    scroll (on the card the first delta of a width captures its graph,
    the second replays it): the chunks (ids, gains), numpy."""
    rng = np.random.default_rng(9)
    sess = rr.session(req)
    out = [sess.next_chunk(4) for _ in range(3)]
    for lo in (100, 140):
        f = rng.standard_normal((40, req.feats.shape[1])).astype(np.float32)
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        sess.extend(rng.uniform(size=40).astype(np.float32), f)
        out.append(sess.next_chunk(4))
        ids = np.concatenate([sess.shown[:2], sess._gid[lo:lo + 30]])
        sess.rescore(ids, rng.uniform(size=ids.size).astype(np.float32))
        out.append(sess.next_chunk(4))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("window", [3, 5])
def test_session_on_card_matches_plain_and_rerank(card, window):
    from repro_torch.serving import SessionConfig

    cfg = DPPRerankConfig(use_kernel=True, shortlist=300, slate_size=12,
                          alpha=3.0, window=window, eps=1e-6)
    scfg = SessionConfig(capacity=400)
    gpu = Reranker(cfg, session_config=scfg, device="cuda")
    req = _session_feed()
    ei, ed = (x.cpu().numpy() for x in gpu.rerank(req))
    cuda.reset_launch_counts()
    got = _session_verbs(gpu, req)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"fused_chunk_windowed": 7}
    # both widths' deltas went through their CUDA graphs
    (sess,) = gpu.sessions._sessions.values()
    assert 64 in sess._stages
    assert all(st.graph is not None for st in sess._stages.values())
    # the first 12 items are the K2 slate, d_hist bit for bit
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got[:3]]),
                                  ei)
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got[:3]]),
                                  ed)
    want = _session_verbs(Reranker(cfg, session_config=scfg, device="cpu"),
                          req)
    for (gi, gd), (wi, wd) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_session_eviction_on_card_matches_control(card):
    from repro_torch.serving import SessionConfig

    cfg = DPPRerankConfig(use_kernel=True, shortlist=300, slate_size=12,
                          alpha=3.0, window=4, eps=1e-6)
    rr = Reranker(cfg, session_config=SessionConfig(budget_bytes=1),
                  device="cuda")
    ctl = Reranker(cfg, device="cuda")
    req, other = _session_feed(4), _session_feed(5)
    a, c = rr.session(req, sid="a"), ctl.session(req)
    for step in range(4):
        rr.session(other, sid=f"b{step}").next_chunk(2)  # evicts a
        assert not a.resident
        ia, da = a.next_chunk(4)
        ic, dc = c.next_chunk(4)
        np.testing.assert_array_equal(ia, ic)
        np.testing.assert_allclose(da, dc, rtol=1e-5, atol=1e-5)
        assert a._state.C.is_cuda and a._state.win.dtype == torch.int32


@pytest.mark.gpu
def test_stopped_session_launches_nothing(card):
    from repro_torch.serving import RerankRequest

    rng = np.random.default_rng(13)
    basis = np.linalg.qr(rng.normal(size=(8, 2)))[0]
    f = (rng.normal(size=(64, 2)) @ basis.T).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    req = RerankRequest(scores=rng.uniform(size=64).astype(np.float32),
                        feats=f)
    rr = Reranker(DPPRerankConfig(use_kernel=True, shortlist=64,
                                  slate_size=12, alpha=3.0, window=4,
                                  eps=0.05), device="cuda")
    sess = rr.session(req)
    cuda.reset_launch_counts()
    assert len(sess.next_chunk(4)[0]) == 2  # eps-stops inside the chunk
    assert sess.next_chunk(4)[0].size == 0
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"fused_chunk_windowed": 1}


@pytest.mark.gpu
def test_session_launches_on_the_current_stream(card):
    """A session's chunk launcher is built on the default stream and then
    called on a side stream that is busy: the K6 launch queues behind
    the side stream's extend, so the chunk sees the new candidates, as a
    control session on the default stream does."""
    cfg = DPPRerankConfig(use_kernel=True, shortlist=300, slate_size=12,
                          alpha=3.0, window=4, eps=1e-6)
    req = _session_feed(6)
    rng = np.random.default_rng(21)
    f = rng.standard_normal((40, req.feats.shape[1])).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    # relevance 3^4 and up against the pool's 3^1 at most: picked first
    scores = rng.uniform(4.0, 5.0, size=40).astype(np.float32)
    ctl = Reranker(cfg, device="cuda").session(req)
    sess = Reranker(cfg, device="cuda").session(req)
    for s in (ctl, sess):
        s.next_chunk(4)  # builds the launcher on the default stream
    ctl.extend(scores, f)
    wi, wd = ctl.next_chunk(4)
    assert np.any(wi >= req.num_candidates)  # the extend is seen
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)  # the side stream busy first
        sess.extend(scores, f)
        gi, gd = sess.next_chunk(4)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The shard-local update entries of K3 / K4 (the candidate-sharded path)
# ---------------------------------------------------------------------------


def _update_lanes(windowed, rows, t):
    """Each lane's step counter: lane 0 at ``t``, lane 1 (stopped) and
    lane 2 shallower, lane 3 exact at the state's k rows (latched) or,
    windowed, deeper with its ring full."""
    last = rows if not windowed else t + rows + 1
    return [t, max(t - 2, 0), t // 2, last]


def _update_operands(windowed, D, M, rows, t, base, seed):
    """Four lanes at their own depths (:func:`_update_lanes`) on a shard
    whose first global id is ``base``: lane 0 owns its winner, lane 1 is
    stopped, lanes 2 and 3's winners lie on another shard.  Returns the
    entry's operands on the CPU."""
    rng = np.random.default_rng(seed)
    B = 4
    f32 = np.float32
    ts = np.array(_update_lanes(windowed, rows, t), np.int32)
    V = (rng.standard_normal((B, D, M)) / np.sqrt(D)).astype(f32)
    C = (0.1 * rng.standard_normal((B, rows, M))).astype(f32)
    cj = (0.1 * rng.standard_normal((B, rows))).astype(f32)
    if not windowed:
        for b, tb in enumerate(ts):
            C[b, tb:] = 0.0
            cj[b, tb:] = 0.0
    d2 = (1.0 + rng.uniform(size=(B, M))).astype(f32)
    d2[rng.uniform(size=(B, M)) < 0.1] = -np.inf
    ops = dict(
        Vl=V, C=C, d2=d2,
        vj=(rng.standard_normal((B, D)) / np.sqrt(D)).astype(f32), cj=cj,
        dj=(0.5 + rng.uniform(size=B)).astype(f32),
        stopped=np.array([False, True, False, False]),
        j=np.array([base + 5, base + 7, base + M + 3, base - 2], np.int32),
        t=ts)
    if windowed:
        # Givens pairs where the ring is full, identity rotations where it
        # is not (as eviction_coeffs gives them)
        full = (ts >= rows) & ~ops["stopped"]
        ang = np.where(full[:, None],
                       rng.uniform(0, np.pi, size=(B, rows - 1)), 0.0)
        ops.update(full=full, cos=np.cos(ang).astype(f32),
                   sin=np.sin(ang).astype(f32))
    return {k_: torch.from_numpy(v) for k_, v in ops.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("windowed,D,M,rows,t,tile_m", [
    (False, 32, 777, 20, 6, 128),     # ragged: 7 tiles
    (False, 100, 3000, 50, 12, 1024),  # phase 3's width, a ragged tile
    (False, 16, 5000, 5, 4, 256),     # the last row
    (True, 32, 777, 20, 6, 128),
    (True, 100, 3000, 10, 12, 1024),  # phase 4's width and window, full
    (True, 16, 5000, 5, 2, 256),      # the ring not full yet
    (True, 16, 5000, 5, 9, 256),      # full, evicting
])
def test_update_entries_match_plain(card, windowed, D, M, rows, t, tile_m):
    """Each update entry against its plain version, four lanes at their
    own step counters in one launch: the stopped lane and the exact lane
    at the state's k rows keep their state, every lane's key lands in its
    row ``(t + 1) & 1`` and the row ``t & 1`` it read is zeroed."""
    base = 40_000
    cpu = _update_operands(windowed, D, M, rows, t, base, seed=t)
    gpu = {k_: v.cuda() for k_, v in cpu.items()}
    ts = _update_lanes(windowed, rows, t)
    lanes = torch.arange(4)
    outs = []
    for ops in (cpu, gpu):
        keys = torch.full((2, 4), 7, dtype=torch.int64,
                          device=ops["Vl"].device)
        keys[(torch.tensor(ts) + 1) & 1, lanes] = 0  # the row to fold into
        if windowed:
            args = [ops[n] for n in ("Vl", "C", "d2", "vj", "cj", "dj",
                                     "stopped", "full", "cos", "sin", "j",
                                     "t")]
            fn = (tiled.tiled_update_windowed if ops is gpu
                  else tiled.tiled_update_windowed_plain)
        else:
            args = [ops[n] for n in ("Vl", "C", "d2", "vj", "cj", "dj",
                                     "stopped", "j", "t")]
            fn = (tiled.tiled_update_exact if ops is gpu
                  else tiled.tiled_update_exact_plain)
        cuda.reset_launch_counts()
        fn(*args, base, keys, tile_m)
        outs.append((ops["C"].cpu(), ops["d2"].cpu(), keys.cpu()))
    torch.cuda.synchronize()
    name = "tiled_update_windowed" if windowed else "tiled_update_exact"
    assert cuda.launch_counts() == {name: 1}
    (Cp, dp, kp), (Cg, dg, kg) = outs
    torch.testing.assert_close(Cg, Cp, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(dg, dp, rtol=RTOL, atol=ATOL)
    read = torch.tensor(ts) & 1
    assert bool((kg[read, lanes] == 0).all()) and bool(
        (kp[read, lanes] == 0).all())
    vp, ip = tiled.unpack_key(kp[1 - read, lanes])
    vg, ig = tiled.unpack_key(kg[1 - read, lanes])
    assert torch.equal(ig, ip) and bool(((ig >= base)
                                         & (ig < base + M)).all())
    torch.testing.assert_close(vg, vp, rtol=RTOL, atol=ATOL)
    # the owner masked its winner; the stopped lane (and, exact, the lane
    # at the state's k rows) kept its state
    assert dg[0, 5].item() == float("-inf")
    orig = _update_operands(windowed, D, M, rows, t, base, seed=t)
    for b in (1,) if windowed else (1, 3):
        assert torch.equal(Cg[b], orig["C"][b])
        assert torch.equal(dg[b], orig["d2"][b])


@pytest.mark.gpu
@pytest.mark.parametrize("windowed,past", [(False, 0), (False, 5), (True, 9)])
def test_update_entries_write_nothing_past_the_state(card, windowed, past):
    """The last lane's counter at or past the state's rows (exact: ``k +
    past``; windowed: deep in a full ring): ``C``, ``d2`` and ``keys`` are
    views at the head of buffers whose tails hold a sentinel, so a write
    past row ``k - 1``, past a lane's gains or past key row 1 would land
    in a tail.  Every tail keeps its sentinel, and the entry still agrees
    with its plain version."""
    D, M, rows, t, tile_m, base, B = 32, 777, 6, 4, 128, 0, 4
    ops = _update_operands(windowed, D, M, rows, t, base, seed=11)
    ts = ops["t"].clone()
    ts[3] = rows + past if not windowed else 2 * rows + past
    ops["t"] = ts
    if windowed:
        ops["full"] = (ts >= rows) & ~ops["stopped"]
    gpu = {k_: v.cuda() for k_, v in ops.items()}
    guard = 4 * rows * M
    tails = {}
    for name, shape, dtype, fill in (("C", (B, rows, M), torch.float32,
                                      None),
                                     ("d2", (B, M), torch.float32, None),
                                     ("keys", (2, B), torch.int64, 0)):
        n = int(np.prod(shape))
        buf = torch.full((n + guard,), 12345, dtype=dtype, device="cuda")
        view = buf[:n].view(shape)
        view.copy_(gpu[name] if fill is None else torch.full(
            shape, fill, dtype=dtype, device="cuda"))
        gpu[name], tails[name] = view, buf[n:]
    keys_cpu = torch.zeros((2, B), dtype=torch.int64)
    names = (("Vl", "C", "d2", "vj", "cj", "dj", "stopped", "full", "cos",
              "sin", "j", "t") if windowed
             else ("Vl", "C", "d2", "vj", "cj", "dj", "stopped", "j", "t"))
    fn, plain = ((tiled.tiled_update_windowed,
                  tiled.tiled_update_windowed_plain) if windowed
                 else (tiled.tiled_update_exact, tiled.tiled_update_exact_plain))
    fn(*[gpu[n] for n in names], base, gpu["keys"], tile_m)
    plain(*[ops[n] for n in names], base, keys_cpu, tile_m)
    torch.cuda.synchronize()
    for name, tail in tails.items():
        assert bool((tail == 12345).all()), f"{name} written past its end"
    torch.testing.assert_close(gpu["C"].cpu(), ops["C"], rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(gpu["d2"].cpu(), ops["d2"], rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(tiled.unpack_key(gpu["keys"].cpu())[1],
                       tiled.unpack_key(keys_cpu)[1])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo group of one rank in this process, for meshes on the card
    (the collectives stage through host tensors) and on the CPU."""
    import torch.distributed as dist

    from repro_torch.distributed import init_group

    init_group("gloo", 0, 1, tmp_path_factory.mktemp("rdv") / "file",
               timeout_s=60)
    yield
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 4])
def test_sharded_one_rank_on_card_matches_k3_k4(card, one_rank, window):
    from repro_torch.core import dpp_greedy_sharded
    from repro_torch.distributed import make_mesh

    k, eps, tile_m = 20, 1e-6, 256
    V, mask = _inputs(31, B=3, D=32, M=3000)
    cuda.reset_launch_counts()
    got = dpp_greedy_sharded(V.cuda(), k, mesh=make_mesh(device="cuda"),
                             window=window, eps=eps, mask=mask.cuda(),
                             tile_m=tile_m)
    torch.cuda.synchronize()
    name = "tiled_update_exact" if window is None else "tiled_update_windowed"
    assert cuda.launch_counts() == {name: k}
    plain = dpp_greedy_sharded(V, k, mesh=make_mesh(device="cpu"),
                               window=window, eps=eps, mask=mask,
                               tile_m=tile_m)
    want = tiled.dpp_greedy_tiled(V.cuda(), mask.cuda(), k, window, eps,
                                  tile_m)
    assert torch.equal(got.indices.cpu(), plain.indices)
    assert torch.equal(got.indices, want[0])
    torch.testing.assert_close(got.d_hist.cpu(), plain.d_hist, rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(got.d_hist, want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 7])
@pytest.mark.parametrize("window", [None, 4])
def test_sharded_stream_on_card_concatenates_to_whole(card, one_rank, window,
                                                      chunk):
    """The sharded stream on the card: its chunks equal the whole sharded
    slate bit for bit, ``d_hist`` included; one update launcher for the
    stream and one update launch a step."""
    from repro_torch.core import (
        GreedySpec,
        dpp_greedy_sharded,
        greedy_map_chunks,
    )
    from repro_torch.distributed import make_mesh

    k, tile_m = 20, 256
    V, mask = _inputs(33, B=3, D=32, M=3000)
    V, mask = V.cuda(), mask.cuda()
    mesh = make_mesh(device="cuda")
    whole = dpp_greedy_sharded(V, k, mesh=mesh, window=window, eps=1e-6,
                               mask=mask, tile_m=tile_m)
    real, built = tiled.update_launcher, []

    def counted(*args):
        built.append(1)
        return real(*args)

    spec = GreedySpec(k=k, window=window, mesh=mesh, eps=1e-6,
                      tile_m=tile_m, chunk_size=chunk)
    tiled.update_launcher = counted
    try:
        cuda.reset_launch_counts()
        chunks = list(greedy_map_chunks(spec, V=V, mask=mask))
        torch.cuda.synchronize()
    finally:
        tiled.update_launcher = real
    name = "tiled_update_exact" if window is None else "tiled_update_windowed"
    assert cuda.launch_counts() == {name: k} and built == [1]
    assert len(chunks) == -(-k // chunk)
    assert torch.equal(torch.cat([c.indices for c in chunks], 1),
                       whole.indices)
    assert torch.equal(torch.cat([c.d_hist for c in chunks], 1),
                       whole.d_hist)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 4])
def test_reranker_stream_on_a_card_mesh_matches_rerank(card, one_rank,
                                                       window):
    from repro_torch.distributed import make_mesh

    rng = np.random.default_rng(35)
    M, D = 5000, 32
    feats = rng.standard_normal((M, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    req = RerankRequest(scores=rng.uniform(size=M).astype(np.float32),
                        feats=feats)
    cfg = DPPRerankConfig(slate_size=24, shortlist=1000, alpha=3.0,
                          eps=1e-3, window=window, chunk_size=5,
                          mesh=make_mesh(device="cuda"))
    rr = Reranker(cfg, device="cuda")
    sel, dh = rr.rerank(req)
    chunks = list(rr.stream(req))
    assert [c.shape[0] for c, _ in chunks] == [5, 5, 5, 5, 4]
    assert torch.equal(torch.cat([c for c, _ in chunks]), sel)
    assert torch.equal(torch.cat([d for _, d in chunks]), dh)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 4])
def test_router_on_a_card_mesh_matches_sharded_rerank(card, one_rank,
                                                      window):
    """``Reranker.submit`` on a one-rank mesh on the card: requests of
    different M, k and mask on 3 slots, chunks past the capacity of 12;
    every slate equals the per-request sharded rerank's, ids and d_hist
    bit for bit (the entries' per-column code gives the same bits at the
    bucket's width as at the request's), and a pump with live lanes is
    ``chunk`` update launches."""
    from repro_torch.distributed import make_mesh
    from repro_torch.serving import RouterConfig

    rng = np.random.default_rng(37)
    feats = rng.standard_normal((3000, 32)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    catalog = torch.from_numpy(feats).cuda()
    reqs = []
    for i, m in enumerate((3000, 700, 2100, 1200, 3000, 450, 1800)):
        mask = rng.uniform(size=m) >= 0.1 if i % 3 == 2 else None
        reqs.append(RerankRequest(
            scores=torch.from_numpy(rng.uniform(size=m).astype(
                np.float32)).cuda(), feats=catalog[:m],
            mask=None if mask is None else torch.from_numpy(mask).cuda(),
            slate_size=int(rng.integers(6, 13))))
    cfg = DPPRerankConfig(slate_size=12, shortlist=500, alpha=3.0,
                          eps=1e-3, window=window,
                          mesh=make_mesh(device="cuda"))
    rr = Reranker(cfg, router_config=RouterConfig(
        slots=3, chunk_size=5, max_candidates=3000), device="cuda")
    cuda.reset_launch_counts()
    handles = [rr.submit(r) for r in reqs]
    rr.router.drain()
    torch.cuda.synchronize()
    name = "tiled_update_exact" if window is None else "tiled_update_windowed"
    assert cuda.launch_counts() == {name: 5 * rr.router.stats.chunks_launched}
    for h, r in zip(handles, reqs):
        gi, gd = h.slate()
        ei, ed = (x.cpu().numpy() for x in rr.rerank(r))
        np.testing.assert_array_equal(gi, ei)
        np.testing.assert_array_equal(gd, ed)


# ---------------------------------------------------------------------------
# Measured tile choice (tile_m="auto") on the card
# ---------------------------------------------------------------------------


def _chunk_cap(windowed):
    return tiled.capacity_fn(windowed, torch.device("cuda"))


@pytest.mark.gpu
def test_smoke_sweep_on_card_yields_entries_lookup_hits(card, tmp_path):
    from repro_torch.kernels.dpp_greedy import autotune as tat

    path = str(tmp_path / "cache.json")
    results, _ = tat.run_sweep(tat.smoke_cases(), trials=1, limit=3,
                               path=path, device="cuda")
    assert [r["case"] for r in results] == tat.smoke_cases()
    for r in results:
        c = r["case"]
        assert r["best_us"] > 0 and r["tile_m"] in r["candidates"]
        assert tat.lookup_tile(
            D=c.D, M=c.M, state_rows=c.state_rows, windowed=c.windowed,
            chunked=c.chunked,
            capacity=_chunk_cap(c.windowed) if c.chunked else None,
            device="cuda", path=path) == r["tile_m"]


@pytest.mark.gpu
@pytest.mark.parametrize("family,tile,kernel", [
    ("step_exact", 512, "tiled_step_exact"),
    ("step_windowed", 4096, "tiled_step_windowed"),
    ("chunk_exact", 2048, "fused_chunk_exact"),
    ("chunk_windowed", 512, "fused_chunk_windowed"),
])
def test_auto_equals_the_model_default_on_card(card, tmp_path, monkeypatch,
                                               family, tile, kernel):
    from repro_torch import obs
    from repro_torch.kernels.dpp_greedy import autotune as tat

    case = next(c for c in tat.smoke_cases() if c.family == family)
    dev = torch.device("cuda")
    assert tile != tat.model_tile(case.D, case.M, case.state_rows,
                                  case.windowed, case.chunked,
                                  capacity=_chunk_cap(case.windowed))
    cache = tat.AutotuneCache(str(tmp_path / "cache.json"), {})
    cache.put(D=case.D, M_bucket=case.M, state_rows=case.state_rows,
              windowed=case.windowed, chunked=case.chunked, tile_m=tile,
              best_us=1.0, candidates={tile: 1.0}, plain=False,
              device=tat.device_fingerprint(dev))
    cache.save()
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", cache.path)
    monkeypatch.delenv("DPP_TILE_M", raising=False)
    V = tat.case_inputs(case, dev)
    out = {}
    with obs.session(obs.ObsConfig(enabled=True)):
        for tile_m in ("auto", None):
            spec = GreedySpec(k=case.k, window=case.window, backend="kernel",
                              eps=1e-6, tile_m=tile_m,
                              chunk_size=case.chunk if case.chunked
                              else None)
            cuda.reset_launch_counts()
            res = greedy_map(spec, V=V)
            torch.cuda.synchronize()
            out[tile_m] = (res.indices, res.d_hist, cuda.launch_counts())
        hits = obs.registry().counter("autotune_cache_hits_total").total()
        assert obs.registry().gauge("autotune_tile_m").value() == tile
    assert hits >= 1
    (a_sel, a_dh, a_n), (m_sel, m_dh, m_n) = out["auto"], out[None]
    assert set(a_n) == set(m_n) == {kernel}
    assert torch.equal(a_sel, m_sel) and torch.equal(a_dh, m_dh)


@pytest.mark.gpu
def test_static_checks_on_the_card_capacities(card, tmp_path, monkeypatch):
    """``repro_torch.analysis`` over the port with the card's own
    occupancy queries: zero findings, every cooperative family's largest
    grid within what the card keeps co-resident."""
    from pathlib import Path

    from repro_torch.analysis import run_analysis
    from repro_torch.analysis.kernels import COOPERATIVE, card_capacities

    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", str(tmp_path / "absent.json"))
    monkeypatch.delenv("DPP_TILE_M", raising=False)
    root = Path(__file__).resolve().parents[1]
    findings, summary = run_analysis(
        [str(root / "src" / "repro_torch")],
        capacities=card_capacities(torch.device("cuda")))
    assert findings == [], "\n".join(f.format() for f in findings)
    per = summary["kernel_contracts"]["per_family"]
    for fam in COOPERATIVE:
        assert 0 < per[fam]["largest_grid"] <= per[fam]["co_resident"]


@pytest.mark.gpu
def test_fig8_full_on_the_card(card):
    """Figure 8 at its --full size: its gates (no rebuild after warmup,
    router slates equal to their K1 rerank bit for bit) and its K5
    launches, the router's and the serial streams'."""
    from repro_torch import obs
    from repro_torch.figures import fig8_observability as fig8

    cuda.reset_launch_counts()
    try:
        rows, failures, slates = fig8.run(False, device="cuda")
        torch.cuda.synchronize()
    finally:
        obs.disable()
    assert failures == []
    counts = cuda.launch_counts()
    assert counts.get("fused_chunk_exact", 0) > 0
    assert counts.get("dpp_greedy_resident") == len(slates) == 32
    assert [r[0] for r in rows][:5] == [
        f"fig8_pump_{p}" for p in fig8.PUMP_PHASES + ("sync",)]


def _unit_features(B, D, M, seed):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, D, M)).astype(np.float32)
    F /= np.linalg.norm(F, axis=1, keepdims=True)
    return torch.from_numpy(F * np.exp(rng.uniform(size=(B, 1, M))
                                       * np.log(4.0)).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2])
def test_k1_at_lm_width_matches_plain(card, B):
    """K1 at D = 2560 (qwen1.5-4b's d_model), M = 64, k = 10."""
    V = _unit_features(B, 2560, 64, 11).cuda()
    d2 = init_gains(V, torch.ones(B, 64, dtype=torch.bool, device="cuda"))
    cuda.reset_launch_counts()
    got = dpp_greedy_resident(V, d2, 10, 1e-3)
    torch.cuda.synchronize()
    assert cuda.launch_counts() == {"dpp_greedy_resident": 1}
    want = dpp_greedy_resident_plain(V, d2, 10, 1e-3)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_prefill_decode_on_card_matches_forward_and_cpu(card):
    from repro_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(
        name="tiny-mixed", n_layers=6, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=64, window=8, global_every=3, dtype=torch.float32,
        chunk_q=16)
    model = tfm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    cpu = tfm.Transformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    S, extra = 20, 3
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, S + extra)))
    with torch.inference_mode():
        hidden, _, _ = tfm.forward_hidden(model, toks.cuda(), cfg)
        full = tfm.logits_from_hidden(model, hidden).float()
        logits, cache = tfm.prefill(model, toks[:, :S].cuda(), cfg, 40)
        clogits, ccache = tfm.prefill(cpu, toks[:, :S], cfg, 40)
        steps = [(logits, clogits)]
        for t in range(extra):
            step = toks[:, S + t:S + t + 1]
            logits, cache = tfm.decode_step(model, cache, step.cuda(), cfg)
            clogits, ccache = tfm.decode_step(cpu, ccache, step, cfg)
            steps.append((logits, clogits))
    for t, (got, want) in enumerate(steps):
        torch.testing.assert_close(got, full[:, S - 1 + t], rtol=3e-3,
                                   atol=3e-3)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
