#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the DPP rerank, DeepFM
scoring into the rerank, the fused scoring top-c, the paper's
experiments, the continuous-batching router, session-aware incremental
rerank and the candidate-sharded rerank, stream and router.

    python3 chip_smoke.py
    python3 chip_smoke.py --resident-times   # K1, K2 alone (resident_times)
    python3 chip_smoke.py --update-times     # the update entries alone

(Phase 12 runs ``chip_smoke.py --topk-device-times STATE`` as a child
process for K7's profiler times: ``topk_device_times``.)

Builds the port's CUDA kernels from ``src/repro_torch`` (nvcc, sm_90a),
then runs twenty phases through the port's entry points.  Phases 1-9
(``repro_torch.serving.Reranker(..., use_kernel=True).rerank`` and
``.stream``, ``repro_torch.core.greedy_map_chunks`` and
``greedy_chunk_slots``) run at the paper's §5.1 setup: D = 100
column-normalised Gaussian features, uniform relevance, alpha = 3,
eps = 1e-3, inputs made with numpy from a fixed seed.

1. resident exact:    B = 64 users, pool 100,000, shortlist 1000, k = 50,
                      plus one single request; K1 runs each user on a
                      cluster of 2 CTAs with V in shared memory (checked);
                      the single request is also timed at 1, 2, 4 and 8
                      CTAs a cluster;
2. resident windowed: phase 1 with window 10, k = 200; K2 on clusters of
                      2 CTAs with V and the ring in shared memory;
3. tiled exact:       B = 4 users, pool 1,000,000, shortlist 65,536,
                      k = 50, 10% of the pool masked as seen;
4. tiled windowed:    phase 3 with window 10, k = 200; a TorchDispatchMode
                      around a second main-path call shows that no aten
                      op runs between its first and last K4 launch;
5. forced tile:       phase 1's inputs with tile_m = 256; the tiled slate
                      and d_hist must equal the resident ones bit for
                      bit; K3 timed alone at this shape;
6. stream:            ``Reranker.stream`` of phase 1's first user, chunk 8
                      (seven K5 launches, V in shared memory over two
                      tiles of 512); the concatenated slate must equal
                      that user's K1 slate;
7. chunks windowed:   ``greedy_map_chunks`` on phase 2's shortlists
                      (B = 64, w = 10, k = 200, chunk 16) on K6 with its
                      V tiles in shared memory, against K2's whole slate;
8. chunks large pool: ``greedy_map_chunks`` on phases 3 and 4's
                      shortlists (B = 4, C = 65,536, k = 50 exact and
                      k = 200 at w = 10, chunk 16), several cooperative
                      blocks per lane, V streamed, against K3 / K4;
9. slots:             ``greedy_chunk_slots`` on 64 slots (exact, k = 50,
                      chunk 8) holding phase 1's users, half of them
                      spliced in two chunks after the rest, V in shared
                      memory over two tiles per slot; K5 is held against
                      its plain version on the same run and timed, and
                      each slot must equal its user's K1 slate and its
                      single-request stream.

Phases 10-12 run the recsys serving path, ``repro_torch.launch.serve.
serve_batch``, at DeepFM's published width (arXiv:1703.04247: 39 fields,
22,187,008 fused rows x embed 10, MLP 400-400-400; random weights from a
seeded ``torch.Generator``), and ``repro_torch.kernels.scored_topk``:

10. recsys serve:     the ``serve_p99`` shape, B = 512 users x 2000
                      candidates (1,024,000 scored rows), shortlist 200,
                      slate 10: K8 once per forward, K1 once; first-batch
                      and steady host wall;
11. retrieval:        the ``retrieval_cand`` shape, one user x 10^6
                      candidates, shortlist 1000, slate 50; diversity from
                      the slate's own rows;
    reference check:  phase 10's first 4 users through the same
                      ``serve_batch`` on the CPU with the parameters
                      copied there: scores within rtol 1e-5 / atol 1e-6,
                      slates equal up to a certified near-tie;
12. scored_topk:      exact ties (small integers, M = 100,000, D = 16,
                      c = 1000) index for index; timed (phase 3's pool,
                      M = 10^6, D = 100, c = 1000) against the plain
                      version and ``torch.topk(emb @ q, c)``, one launch
                      with no op after it, blocks mode beside it; the
                      same pool with its scores ascending with the row
                      index; ragged (M = 10^6 + 3, D = 10, c = 128); each
                      with K7's launch plan printed.

Phase 13 runs the paper's experiments, ``repro_torch.figures``, on the
card through each figure's ``main`` (its CSV printed):

13. paper experiments: fig1 at the paper's N = 5..50 (M = 1000, D = 100):
                      the card's float64 batched-slogdet naive greedy,
                      the torch core and K1 at every N, the numpy float64
                      naive greedy to N = 20; every slate equals the
                      float64 naive slate up to a certified near-tie, and
                      the speedups are printed; fig2 at N = 5..50: MMR and
                      greedy-avg equal the same calls on the CPU, K1 the
                      torch core up to a certified near-tie; fig3 in fast
                      mode: every user's slate equals the port's CPU
                      slate, a Div-DPP slate up to a certified near-tie;
                      fig4 and fig6 at their --smoke sizes: gate-sweep
                      parity with a past-the-gate cell on K4 (one launch
                      a step), the N-sweep's per-step cost printed; one
                      K6 launch a chunk, the streamed slate equal to the
                      whole slate, the first chunk before the whole
                      slate; the quickstart on K1.  Each figure's K1, K2,
                      K4 and K6 launches are counted and printed, and
                      added to the kernels' record.

Phase 14 runs the continuous-batching router, ``Reranker.submit`` /
``RerankRouter`` (``repro_torch.serving.router``), on the card:

14. router:           (a) exact, phase 1's draw (D = 100, alpha = 3,
                      eps = 1e-3): 192 single requests over a catalog of
                      100,000 items, pools of 500..100,000 (some narrower
                      than the 1000-column bucket), k in [25, 50], a 10%
                      seen mask every third, four with a lapsed deadline;
                      64 slots of capacity 50, chunk 8 (K5); the first 64
                      in a burst, then 8 a pump; (b) the same windowed,
                      w = 10, capacity 200, k in [100, 200], chunk 16
                      (K6); every slate must equal its per-request rerank
                      (K1 / K2) index for index and d_hist bit for bit or
                      part at a certified float64 near-tie, and the plain
                      chunk version's router slates; one launch a pump
                      with active lanes (``router_chunks_launched_total``),
                      the lifecycle counts the inputs force, no kernel
                      build or load and one slot-state allocation; the
                      pump's host wall by span, TTFC, fill, peak
                      concurrency, the share of pumps whose next chunk was
                      still running when the last was delivered, and
                      K5 / K6 device time a launch are printed; (c)
                      ``launch.serve_router`` on phase 10's DeepFM model:
                      64 requests x 2000 candidates, shortlist 200, slate
                      10, 16 slots, chunk 4, every slate (the warm set's
                      too) against K1, ``rebuilds_after_warmup`` 0; (d)
                      Figure 7 (``repro_torch.figures.fig7_serving``) at
                      its --smoke size through its ``main`` and its gates.

Phase 15 runs session-aware incremental rerank, ``Reranker.session`` /
``RerankSession`` (``repro_torch.serving.session``), on K6 at phase 1's
setup (a 100,000-item catalog, shortlist 1000, D = 100, alpha = 3,
eps = 1e-3), window 10, chunk 8, capacity 2000 (888,045 B of device
state a session):

15. sessions:         (a) 32 sessions scroll 4 chunks each, round robin:
                      each session's 32 items equal its K2 rerank index
                      for index and d_hist bit for bit, and K6 is held
                      against its plain version on the same sessions;
                      K6's device time a session launch; (b) extend(128)
                      and rescore(64) interleaved with scrolls on them,
                      every post-delta chunk against the float64
                      conditional greedy over the host mirrors (parting
                      only at a certified near-tie), and a rank-2 session
                      (eps 0.05) that stops, launches nothing while
                      stopped and is revived by an extend; (c) the 32
                      requests under budget_bytes = 8 MiB (9 resident)
                      against a store that never evicts: every chunk
                      equal to the control's, the control's against K2
                      and float64, resident bytes within the budget plus
                      one session, the session metrics printed; (d)
                      Figure 10 (``repro_torch.figures.fig10_session``) at
                      its --smoke size through its ``main`` and its
                      parity and latency gates; (e) ``examples/
                      serve_recsys.py``'s ``session_demo`` against the
                      same demo on the CPU.  One K6 launch a live
                      ``next_chunk``, none for a stopped session; each
                      verb's host wall from its span.

Phase 16 runs the candidate-sharded whole-slate rerank,
``Reranker(DPPRerankConfig(mesh=...)).rerank``
(``repro_torch.serving.sharded_rerank``, ``repro_torch.core.sharded``)
in ranks of a ``torch.distributed`` group that ``python -m
repro_torch.launch.serve_sharded`` starts as child processes, last, after
phase 15's wall-clock gates:

16. sharded rerank:   (c) first, in this process on a one-rank gloo
                      group: each shard-local update entry of K3/K4
                      (``tiled_update_exact`` / ``_windowed``) against its
                      plain version, a whole slate on phase 3's shortlist
                      (B = 4, C = 65,536, k = 50; w = 10, k = 200) as the
                      shard from global id 3 C on, timed as K3/K4 are;
                      (a) one NCCL rank on phase 3/4's request (pool
                      10^6, a 10% seen mask, V 1.6 GB on the rank): slates
                      against phase 3/4's K3/K4 rerank; (b) phase 1's
                      first 8 users (pool 100,000, C = 1000) under 1 NCCL
                      rank and 2 and 4 gloo ranks sharing the card, the
                      three runs at once: every rank's slate equal to the
                      others' and to the one-rank run's, which is held
                      against phase 1/2's K1/K2 rerank.  Each rank runs
                      k update launches a call and nothing else; each
                      run's host wall by rank and its collectives' share
                      (a third call that synchronises around each
                      collective) are printed.  A child that fails or
                      passes its time limit fails the phase with its
                      stderr tail.

Phase 17 runs the candidate-sharded stream (``core.dispatch.
greedy_map_chunks`` and ``Reranker.stream`` on a mesh) and figure 5,
after phase 16, on the same update entries:

17. sharded stream:   (a) in this process on 16(c)'s one-rank gloo group:
                      ``greedy_map_chunks``, chunk 16, over 16(c)'s shard
                      (exact k = 50; w = 10, k = 200): the chunks equal
                      16(c)'s whole slate bit for bit, d_hist included,
                      k update launches through one launcher a call, the
                      update-entry device time beside 16(c)'s; (b)
                      ``launch.serve_sharded --stream 8`` on phase 1's
                      user 0 (pool 100,000, C = 1000), one NCCL rank and
                      2 gloo ranks sharing the card: every rank's chunks
                      equal its whole slate, the two runs equal, each
                      held against phase 1/2's K1/K2 slate (certified
                      near-ties), time to first chunk and the whole
                      stream printed; (c) figure 5
                      (``repro_torch.figures.fig5_sharded``) at its
                      --smoke size through its ``main``, P = 1 (NCCL)
                      and 2 (gloo): its rows and its update launches.
                      (b)'s and (c)'s children start at once.

Phase 18 runs the continuous-batching router on the candidate-sharded
mesh (``Reranker(DPPRerankConfig(mesh=...)).submit``, the slot
``ShardedState`` with a step counter a lane in the update entries),
after phase 17:

18. router on a mesh: (a) in this process on 16(c)'s one-rank gloo
                      group: 96 requests of phase 14(a)'s draw over a
                      100,000-item catalog (pools 500..100,000, k in
                      [25, 50], a 10% seen mask every third, two lapsed
                      deadlines) on 32 slots of capacity 50, a bucket of
                      100,000 columns, chunk 8; then 32 windowed, w = 10,
                      capacity 200, k in [100, 200], chunk 16.  Every
                      slate equals its per-request sharded rerank on the
                      mesh index for index and d_hist bit for bit, and
                      phase 14's K1 / K2 rerank or parts from it at a
                      certified float64 near-tie; the same router on
                      the plain update entry beside it; the lifecycle
                      counts the inputs force; chunk update launches a
                      pump with live lanes; host wall a pump by span,
                      TTFC and the entries' device time a pump, measured
                      before (b) starts (the references run with it); (b)
                      ``launch.serve_sharded --router 24`` on phase 1's
                      catalog (two lapsed deadlines, one of 0.05 s that
                      the gloo ranks' run must see lapse mid-flight), 8
                      slots, chunk 8, exact and w = 10: one
                      NCCL rank and 2 gloo ranks sharing the card, at
                      once; every rank's handles and timed_out flags
                      equal rank 0's, the two runs' slates equal where
                      neither timed out, each held against phase 1's
                      K1 / K2 rerank; TTFC and the decision collective's
                      share of a pump.

Phase 19 runs the measured tile choice (``tile_m="auto"``, the
``DPP_TILE_M`` override) on K3-K6, last.  The script drops
``DPP_TILE_M`` and points ``DPP_AUTOTUNE_CACHE`` at a file of its own
temporary directory when it starts, so no earlier phase depends on the
machine's tile settings:

19. measured tile:    (a) ``run_sweep`` of ``smoke_cases()`` (D = 64,
                      M = 65,536, one lane) and ``serving_cases()``
                      (phases 3/4/8's D = 100, C = 65,536, B = 4, and K3 /
                      K4 at one lane) into that cache, every candidate's
                      time printed; (b) Figure 9
                      (``repro_torch.figures.fig9_autotune``) at its
                      --smoke size with its four gates: the measured tile
                      within 2x of the model's, a cache hit, no rebuild
                      after warmup, slates equal to the model tile's bit
                      for bit and the torch core's; (c) phase 3's and
                      phase 4's request and one single request of that
                      pool through ``Reranker(..., tile_m="auto")``, and
                      phase 8's chunks under ``"auto"``: each an exact
                      cache hit whose slate and d_hist equal the model
                      tile's (phases 3, 4, 8) bit for bit, with K3-K6's
                      device time at the measured tile and at the model's;
                      (d) phase 6's stream under ``"auto"``, equal to
                      phase 6's; (e) ``DPP_TILE_M=256`` over ``tile_m=512``
                      on phase 1's inputs, equal to phase 5's slate, the
                      override counted.  Its time is printed against its
                      30 s aim.

Phase 20 runs the static checks and Figure 8 on the card, after phase 19
(so the autotune cache it validates is phase 19's):

20. static checks:    (a) ``repro_torch.analysis.run_analysis`` over
                      ``src/repro_torch`` and this script, the kernel
                      contracts given the card's own capacity queries
                      (``analysis.kernels.card_capacities``): zero
                      findings; the geometries checked per family and,
                      per cooperative family (K5, K6, K7), the largest
                      grid against what the card keeps co-resident;
                      (b) Figure 8 (``repro_torch.figures.
                      fig8_observability``) at its --full size (M = 1024,
                      D = 32, shortlist 256, k in [16, 32], 4 slots,
                      chunk 4, 32 requests) with its gates: no rebuild
                      after warmup, the pump split complete, a state
                      allocation per distinct serial k, a valid trace,
                      live dispatch counters, every router slate equal
                      to its K1 rerank bit for bit and every stream a
                      prefix of it; each pump phase's mean host
                      microseconds and share of the pump.  Its K5
                      launches go into K5's record.  Its time is printed
                      against its 20 s aim.

Each phase resets the kernels' launch counters right before the main-path
call (phases 16 and 17's ranks in their own processes), reads them right after,
and checks them and the mode recorded in dispatch telemetry; holds the
kernel against its plain PyTorch version on the same inputs (d_hist
rtol 3e-4 / atol 1e-5; a slate may differ only
after a float64-certified near-tie, with every later pick float64
greedy-valid; K8 rtol 1e-5 / atol 1e-6; K7 values within 1e-5); times the
kernel and the plain version with CUDA events (the multi-launch kernels
K3-K6 and the update entries one event pair per launch, summed), with
torch.profiler's device time of the same launches beside it as
``device_ms`` (K1-K7, the update entries); and checks the outputs.
Phases 3, 4 and 6-9 also print the per-step streaming floor beside the
kernel's device time: V's bytes once per step over 3.35 TB/s and, for
the exact kernels, the live Cholesky rows read, row t written and the
gains read and written, since none of it stays on the chip between
steps where V streams (the bound in the kernels' record counts V once;
where K5/K6 keep V in shared memory the floor is a yardstick only).
Every streamed slate must equal its whole-slate kernel slate bit for
bit, d_hist included.
Any failure exits non-zero.  The second-to-last line is the kernels'
JSON record, the last the device line.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
SEED = 0
D, ALPHA, EPS = 100, 3.0, 1e-3
RTOL, ATOL = 3e-4, 1e-5  # tests/conftest.py's incremental-oracle tolerance
TIE_REL = 1e-5  # float64 near-tie / greedy-validity tolerance
HBM_BYTES_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_S = 67e12  # H100 SXM FP32, CUDA cores
TIMING_REPS, PLAIN_REPS, WARMUP = 20, 5, 2
KERNELS = {
    "dpp_greedy_resident": dict(
        source="src/repro_torch/kernels/dpp_greedy/csrc/dpp_greedy.cu",
        replaces="src/repro/kernels/dpp_greedy/dpp_greedy.py:48"),
    "dpp_greedy_resident_windowed": dict(
        source="src/repro_torch/kernels/dpp_greedy/csrc/dpp_greedy.cu",
        replaces="src/repro/kernels/dpp_greedy/dpp_greedy.py:100"),
    "tiled_step_exact": dict(
        source="src/repro_torch/kernels/dpp_greedy/csrc/tiled.cu",
        replaces="src/repro/kernels/dpp_greedy/tiled.py:129"),
    "tiled_step_windowed": dict(
        source="src/repro_torch/kernels/dpp_greedy/csrc/tiled.cu",
        replaces="src/repro/kernels/dpp_greedy/tiled.py:160"),
    "tiled_update_exact": dict(
        source="src/repro_torch/kernels/dpp_greedy/csrc/tiled.cu",
        replaces="src/repro/kernels/dpp_greedy/tiled.py:307"),
    "tiled_update_windowed": dict(
        source="src/repro_torch/kernels/dpp_greedy/csrc/tiled.cu",
        replaces="src/repro/kernels/dpp_greedy/tiled.py:327"),
    "fused_chunk_exact": dict(
        source="src/repro_torch/kernels/dpp_greedy/csrc/chunk.cu",
        replaces="src/repro/kernels/dpp_greedy/tiled.py:398"),
    "fused_chunk_windowed": dict(
        source="src/repro_torch/kernels/dpp_greedy/csrc/chunk.cu",
        replaces="src/repro/kernels/dpp_greedy/tiled.py:463"),
    "scored_topk": dict(
        source="src/repro_torch/kernels/scored_topk/csrc/scored_topk.cu",
        replaces="src/repro/kernels/scored_topk/scored_topk.py:28"),
    "fm_interaction": dict(
        source="src/repro_torch/kernels/fm_interaction/csrc/"
               "fm_interaction.cu",
        replaces="src/repro/kernels/fm_interaction/fm_interaction.py:23"),
}
FM_RTOL, FM_ATOL = 1e-5, 1e-6  # K8 vs plain: f32 sums in another order
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6  # recsys scores, card vs CPU
TK_TOL = 1e-5  # K7 values vs plain: f32 dot products in another order


class SmokeFailure(SystemExit):
    def __init__(self, msg):
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        super().__init__(1)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def make_inputs(rng, B, M, seen_frac=0.0):
    """Uniform relevance (B, M), unit-norm Gaussian features (M, D) and a
    seen-items mask (B, M) (None without one), on the card."""
    scores = rng.uniform(size=(B, M)).astype(np.float32)
    feats = rng.standard_normal(size=(M, D), dtype=np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    mask = rng.uniform(size=(B, M)) >= seen_frac if seen_frac else None
    dev = "cuda"
    return (torch.from_numpy(scores).to(dev), torch.from_numpy(feats).to(dev),
            None if mask is None else torch.from_numpy(mask).to(dev))


# ---------------------------------------------------------------------------
# Float64 certification of slate differences
# ---------------------------------------------------------------------------


def _gains64(V64, diag, mask, prefix, window):
    """Float64 marginal gains d^2 of every candidate given the picks in
    ``prefix`` (the last ``window`` of them for the windowed variant);
    picked and masked candidates at -inf."""
    W = prefix[-window:] if window else prefix
    g = diag.clone()
    if len(W):
        Vw = V64[:, W]
        Lwi = Vw.T @ V64
        g = diag - (Lwi * torch.linalg.solve(Vw.T @ Vw, Lwi)).sum(0)
    g[~mask] = float("-inf")
    if len(prefix):
        g[prefix] = float("-inf")
    return g


def _close(x, y):
    return abs(x - y) <= TIE_REL * max(abs(x), abs(y))


def certify(name, V, mask, sel, ref, window, eps):
    """Compare two slates (B, k) of local ids on the same V (B, D, C).
    A lane may differ only from a float64 near-tie on, and every pick of
    ``sel`` from there on must be float64 greedy-valid.  Returns the lanes
    that diverge."""
    a, r = sel.cpu().numpy(), ref.cpu().numpy()
    lanes = [b for b in range(a.shape[0]) if (a[b] != r[b]).any()]
    for b in lanes:
        V64 = V[b].double()
        diag = (V64 * V64).sum(0)
        m = (torch.ones(V.shape[2], dtype=torch.bool, device=V.device)
             if mask is None else mask[b])

        def gains(prefix):
            pre = torch.as_tensor(prefix, dtype=torch.long, device=V.device)
            return _gains64(V64, diag, m, pre, window)

        certify_lane(f"{name}: lane {b}", gains, a[b], r[b], eps)
    return lanes


def certify_lane(name, gains, a, r, eps):
    """One differing slate ``a`` against ``r`` (local ids, -1 after a
    stop), ``gains(prefix)`` the float64 gains given a prefix of picks:
    the slates must part at a float64 near-tie, and every later pick of
    ``a`` must be float64 greedy-valid.  Returns where they part: (step,
    a's pick, r's pick, and their float64 gains there)."""
    eps2 = float(np.float32(eps) * np.float32(eps))
    p = int(np.nonzero(a != r)[0][0])
    g = gains(a[:p])
    gmax = g.max().item()
    x, y = int(a[p]), int(r[p])
    if x < 0 or y < 0:  # one stopped: the best gain sits at eps^2
        tie = _close(gmax, eps2)
    else:
        tie = _close(g[x].item(), g[y].item())
    check(tie, f"{name} diverges at step {p} ({x} vs {y}) without a "
               f"float64 near-tie")
    where = (p, x, y, g[x].item() if x >= 0 else None,
             g[y].item() if y >= 0 else None)
    for q in range(p, a.shape[0]):
        x = int(a[q])
        g = gains(a[:q])
        gmax = g.max().item()
        if x < 0:
            check(gmax <= eps2 or _close(gmax, eps2),
                  f"{name} stops at step {q} with gain {gmax}")
            check((a[q:] < 0).all(), f"{name} resumes")
            break
        check(_close(g[x].item(), gmax) or g[x].item() >= gmax,
              f"{name} step {q} picks {x} (gain {g[x].item()}) below the "
              f"float64 best {gmax}")
    return where


def dense_gains(L64):
    """``gains(prefix)`` for :func:`certify_lane` on an explicit float64
    kernel ``L64`` (M, M): ``L_ii - L_iP L_PP^-1 L_Pi``, picks at -inf."""
    diag = torch.diagonal(L64).clone()

    def gains(prefix):
        g = diag.clone()
        if len(prefix):
            P = torch.as_tensor(prefix, dtype=torch.long, device=L64.device)
            LPi = L64[P]
            g = diag - (LPi * torch.linalg.solve(L64[P][:, P], LPi)).sum(0)
            g[P] = float("-inf")
        return g

    return gains


def compare(name, V, mask, got, want, window, eps):
    """Kernel vs plain on the same inputs: slates certified, d_hist within
    tolerance where the slates agree.  Returns (diverging lanes, max abs
    d_hist error over the agreeing prefixes)."""
    lanes = certify(name, V, mask, got[0], want[0], window, eps)
    agree = torch.cumprod((got[0] == want[0]).to(torch.int32), 1).bool()
    dg, dw = got[1][agree], want[1][agree]
    err = (dg - dw).abs().max().item() if dg.numel() else 0.0
    check(torch.allclose(dg, dw, rtol=RTOL, atol=ATOL),
          f"{name}: d_hist beyond rtol {RTOL} / atol {ATOL} (max abs {err})")
    print(f"  {name}: {len(lanes)} of {got[0].shape[0]} lanes diverge "
          f"(all certified); d_hist max abs err {err:.3g}", flush=True)
    return lanes, err


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def time_events(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs after warmup;
    ``fn`` returns the device milliseconds it measured itself."""
    for _ in range(WARMUP):
        fn()
    return statistics.median(fn() for _ in range(reps))


def event_ms(fn):
    """Device milliseconds of one ``fn()`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def kernel_base(key):
    """A profiler key's kernel name without return type, template
    arguments or parameters: ``void k<true>(float const*, ...)`` -> ``k``."""
    name = key.split("(")[0].split("<")[0]
    return name.split(" ")[-1]


def device_ms(fn, kernel, launches, reps=TIMING_REPS // 4, cuda_name=None):
    """Device time of ``kernel``'s launches in one ``fn()`` call, summed,
    by torch.profiler (CUPTI); the median over ``reps`` profiled calls
    after one warm call.  Unlike a CUDA event pair around a launch it
    leaves out the wrapper's host time.  ``cuda_name`` is the CUDA
    kernel's name (default ``kernel + "_kernel"``), matched over all its
    template instantiations.  A profiled call in which the profiler did
    not see exactly ``launches`` launches of the kernel (CUPTI may drop
    activity records) is discarded and made again, up to ``4 * reps``
    calls in all; None, said on a line of its own, if none of them saw
    every launch."""
    from torch.profiler import ProfilerActivity, profile

    cuda_name = cuda_name or kernel + "_kernel"
    fn()
    out, missed = [], []
    for _ in range(4 * reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages()
                if kernel_base(e.key) == cuda_name]
        seen = sum(e.count for e in mine)
        if seen != launches:
            missed.append(seen)
            others = {kernel_base(e.key) for e in prof.key_averages()
                      if e.device_time_total > 0}
            continue
        out.append(sum(e.device_time_total for e in mine) / 1e3)
        if len(out) == reps:
            break
    if missed:
        print(f"  torch.profiler saw {missed} of {launches} {kernel} "
              f"launches in {len(missed)} profiled calls; those calls were "
              f"discarded (the last one's device activity: "
              f"{sorted(others)})", flush=True)
    return statistics.median(out) if out else None


def bound(B, D, M, k, window, nsteps):
    """Least time for one whole-slate call: the larger of the bytes that
    must move (V and the initial gains read once, sel and d_hist written
    once) over 3.35 TB/s and the FP32 FLOPs the steps this run took need
    (per step and candidate: 2D for L_j, 2 x live rows for the Cholesky
    dot, 4 for e and d2; windowed evictions add 6 per rotation and 2 for
    the repair) over 67 TFLOP/s.  ``nsteps`` (B,) = steps each user ran."""
    nbytes = 4 * B * (D * M + M) + 8 * B * k
    flops = 0
    for n in nsteps:
        for t in range(int(n)):
            if window is None:
                rows, evict = t, 0
            else:
                rows = min(t, window - 1)
                evict = 6 * (window - 1) + 2 if t >= window else 0
            flops += M * (2 * D + 2 * rows + 4 + evict)
    t_bytes, t_flops = nbytes / HBM_BYTES_S, flops / FP32_FLOPS_S
    by = "bytes" if t_bytes >= t_flops else "operations"
    return 1e3 * max(t_bytes, t_flops), by, nbytes, flops


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def drive(rr, req):
    """One main-path call with the launch counters and dispatch telemetry
    reset right before and read right after."""
    from repro_torch import obs
    from repro_torch.kernels import cuda

    obs.disable()
    obs.enable(obs.ObsConfig(enabled=True))
    cuda.reset_launch_counts()
    out = rr.rerank(req)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    modes = obs.registry().counter("dpp_kernel_dispatch_total")._snapshot()
    obs.disable()
    return out, counts, modes


def check_outputs(name, out, B, k, M, mask):
    sel, dh = out
    check(tuple(sel.shape) == (B, k) and tuple(dh.shape) == (B, k),
          f"{name}: output shapes {tuple(sel.shape)} {tuple(dh.shape)}")
    check(sel.dtype == torch.int32 and dh.dtype == torch.float32,
          f"{name}: dtypes {sel.dtype} {dh.dtype}")
    check(bool(torch.isfinite(dh).all()), f"{name}: non-finite d_hist")
    live = sel >= 0
    check(bool(live[:, 0].all()), f"{name}: a user got an empty slate")
    check(bool((sel < M).all()), f"{name}: id out of range")
    check(bool((dh[live] > 0).all()) and bool((dh[~live] == 0).all()),
          f"{name}: d_hist sign/tail")
    for b in range(B):
        ids = sel[b][live[b]]
        check(ids.unique().numel() == ids.numel(), f"{name}: repeated id")
        if mask is not None:
            check(bool(mask[b][ids.long()].all()), f"{name}: masked id")
    return int(live.sum())


class LaunchGapLog(TorchDispatchMode):
    """Each aten op dispatched, with the count of ``kernel``'s launches
    at that moment: an op seen at a count in [1, n) ran between the
    first and the last of n launches."""

    def __init__(self, kernel):
        super().__init__()
        self.kernel, self.ops = kernel, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.kernels import cuda

        self.ops.append((str(func),
                         cuda.launch_counts().get(self.kernel, 0)))
        return func(*args, **(kwargs or {}))


def phase(name, kernel, rr, scores, feats, mask, window, expect_mode,
          expect_launches, records, single=False, watch=False, layout=None):
    """Drive one phase end to end; return the kernel's plain-vs-kernel
    inputs so the caller can reuse them.  ``watch``: a second main-path
    call runs under a :class:`LaunchGapLog`, which must see no op between
    the kernel's first and last launch."""
    from repro_torch.serving import RerankRequest
    from repro_torch.serving.reranker import _shortlist_kernel

    cfg = rr.cfg
    k = cfg.slate_size
    B, M = scores.shape
    print(f"[{name}] B={B} pool={M} shortlist={cfg.shortlist} k={k} "
          f"window={window} tile_m={cfg.tile_m}"
          + ("" if layout is None else f": {layout}"), flush=True)
    req = RerankRequest(scores=scores, feats=feats, mask=mask)
    t0 = time.perf_counter()
    out, counts, modes = drive(rr, req)
    wall = time.perf_counter() - t0
    windowed = window is not None
    check(counts == {kernel: expect_launches},
          f"{name}: launches {counts}, expected {{{kernel!r}: "
          f"{expect_launches}}}")
    check(modes == {f"mode={expect_mode},windowed={windowed}": 1},
          f"{name}: dispatch telemetry {modes}, expected one {expect_mode}")
    n = check_outputs(name, out, B, k, M, mask)
    was = (" (829.3 ms on an H100 when the loop still worked out the "
           "step state in PyTorch between launches)") if watch else ""
    print(f"  main path: {wall * 1e3:.1f} ms host wall{was}, launches "
          f"{counts}, mode {expect_mode}, {n} items selected", flush=True)
    rec = records.setdefault(kernel, {"launches": 0})
    rec["launches"] += counts[kernel]
    if watch:
        log = LaunchGapLog(kernel)
        with log:
            again, a_counts, _ = drive(rr, req)
        check(a_counts == {kernel: expect_launches}
              and torch.equal(again[0], out[0]),
              f"{name}: a second main-path call differs ({a_counts})")
        rec["launches"] += a_counts[kernel]
        gap = [op for op, n in log.ops if 0 < n < expect_launches]
        check(not gap, f"{name}: {len(gap)} aten ops between the first and "
                       f"the last {kernel} launch, e.g. {gap[:5]}")
        before = sum(1 for _, n in log.ops if n == 0)
        after = sum(1 for _, n in log.ops if n >= expect_launches)
        print(f"  the main path again under a TorchDispatchMode: the same "
              f"slate, 0 aten ops between the first and the last of its "
              f"{expect_launches} {kernel} launches ({before} before, "
              f"{after} after)", flush=True)
    if single:
        s_out, s_counts, _ = drive(rr, RerankRequest(
            scores=scores[0], feats=feats,
            mask=None if mask is None else mask[0]))
        check(s_counts == {kernel: expect_launches},
              f"{name}: single-request launches {s_counts}")
        check(torch.equal(s_out[0], out[0][0]),
              f"{name}: single request differs from its batch lane")
        rec["launches"] += s_counts[kernel]
        print(f"  single request: launches {s_counts}, equals lane 0",
              flush=True)
    V, m_top, top_i = _shortlist_kernel(scores, feats, cfg, mask)
    return out, V, m_top, top_i


def kernel_record(records, kernel, ms, plain_ms, bnd, err, note,
                  library_ms=None,
                  library="no library call computes a greedy DPP slate",
                  device=None, reps=TIMING_REPS):
    """Put one kernel's numbers into the JSON record and print them.
    ``ms`` is CUDA event time for every kernel; ``device``, where it was
    measured, the same launches' device time by torch.profiler, kept
    beside it as ``device_ms``."""
    b_ms, by, nbytes, flops = bnd
    rec = records[kernel]
    rec.update(name=kernel, route="cuda", **KERNELS[kernel],
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=by, library_ms=library_ms, device_ms=device)
    lib = "null" if library_ms is None else f"{library_ms:.4f} ms"
    if device is not None:
        note += f"; device time by torch.profiler {device:.4f} ms"
    print(f"  {kernel}: {ms:.4f} ms/call (median of {reps}, {note}), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {by} "
          f"({nbytes} B, {flops} FP32 FLOP), launches/call "
          f"{rec['calls_launches']}, {library} (library_ms {lib})",
          flush=True)


def stream_floor(B, M, steps, ms, v_resident=False, exact=False):
    """Print the per-step streaming floor beside ``ms`` of device time
    (torch.profiler, None when not measured) for ``steps`` steps from
    t = 0: V (B, D, M) float32 read once per step over 3.35 TB/s and,
    ``exact``, the live Cholesky rows (t rows at step t) read, row t
    written and the gains d2 read and written (``v_resident``: the chunk
    kernel keeps V in shared memory, so it reads V from device memory
    once per launch and the floor is a yardstick only)."""
    v_ms = 1e3 * 4 * B * D * M / HBM_BYTES_S
    total = v_ms * steps
    what = "V once per step"
    if exact:
        rows = steps * (steps - 1) // 2 + steps  # read over the steps, + row t
        total += 1e3 * 4 * B * M * (rows + 2 * steps) / HBM_BYTES_S
        what += ", the live C rows, row t and d2"
    step_ms = total / steps
    note = ("; V stays in shared memory here, read from device memory once "
            "per chunk launch" if v_resident else "")
    got = ("device time not measured" if ms is None else
           f"device time {ms / steps * 1e3:.1f} us a step, "
           f"{ms / total:.2f}x the floor")
    print(f"  streaming floor ({what}, over 3.35 TB/s): "
          f"{step_ms * 1e3:.1f} us a step (V alone {v_ms * 1e3:.1f} us, "
          f"{4 * B * D * M} B), {total:.4f} ms for {steps} steps; {got}"
          f"{note}", flush=True)


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound_of(nbytes, flops):
    """(least ms, "bytes" or "operations", bytes, FLOPs): the larger of
    bytes over 3.35 TB/s and FP32 FLOPs over 67 TFLOP/s."""
    t_bytes, t_flops = nbytes / HBM_BYTES_S, flops / FP32_FLOPS_S
    by = "bytes" if t_bytes >= t_flops else "operations"
    return 1e3 * max(t_bytes, t_flops), by, nbytes, flops


# The resident kernels' CUDA names (the other kernels' are their
# wrappers' names + "_kernel").
RESIDENT_CUDA = {"dpp_greedy_resident": "dpp_resident_exact_kernel",
                 "dpp_greedy_resident_windowed":
                     "dpp_resident_windowed_kernel"}


def cluster_line(D_, M, R, windowed, lanes, s=None):
    """The resident kernels' cluster layout of ``lanes`` users on this
    card, as the wrappers get it (``dpp_greedy.cluster_plan``; ``s``
    forces the CTAs a user): (the plan, one line of text)."""
    from repro_torch.kernels.dpp_greedy.dpp_greedy import (
        cluster_capacity,
        cluster_plan,
    )
    from repro_torch.kernels.dpp_greedy.tiling import cluster_smem_bytes

    dev = torch.device("cuda")
    plan = cluster_plan(D_, M, R, windowed, lanes, dev, s)
    smem = cluster_smem_bytes(D_, M, R, windowed, *plan)
    return plan, layout_text(plan, M, windowed, smem, cluster_capacity(
        windowed, plan.s, smem, plan.v_resident, plan.state_resident, dev))


def layout_text(plan, M, windowed, smem, cap):
    """One line for a resident cluster layout of ``smem`` bytes a CTA, of
    which the card holds ``cap`` at once."""
    from repro_torch.kernels.dpp_greedy.tiling import cluster_tile

    state = "ring" if windowed else "Cholesky rows"
    mode = ("V in shared memory" if plan.v_resident else "V streamed") + (
        f", {state} in {'shared' if plan.state_resident else 'device'} "
        f"memory")
    return (f"clusters of {plan.s} CTAs a user, slices of "
            f"{cluster_tile(M, plan.s)} candidates, {mode}, {smem} B of "
            f"shared memory a CTA; the card holds {cap} such clusters at "
            f"once")


def run_resident(records, rng, refs):
    from repro_torch.kernels.dpp_greedy.dpp_greedy import (
        dpp_greedy_resident,
        dpp_greedy_resident_plain,
        dpp_greedy_resident_windowed,
        dpp_greedy_resident_windowed_plain,
        init_gains,
    )
    from repro_torch.serving import DPPRerankConfig, Reranker

    B, M, C = 64, 100_000, 1000
    scores, feats, _ = make_inputs(rng, B, M)
    base = dict(use_kernel=True, shortlist=C, alpha=ALPHA, eps=EPS)
    results = {}
    for name, kernel, k, window in (
        ("phase 1 resident exact", "dpp_greedy_resident", 50, None),
        ("phase 2 resident windowed", "dpp_greedy_resident_windowed", 200,
         10),
    ):
        windowed = window is not None
        plan, line = cluster_line(D, C, window or k, windowed, B)
        check(plan == (2, True, windowed),
              f"{name}: expected clusters of 2 CTAs with V"
              f"{' and the ring' if windowed else ''} in shared memory"
              f"{'' if windowed else ', the Cholesky rows in device memory'}"
              f": {line}")
        rr = Reranker(DPPRerankConfig(slate_size=k, window=window, **base),
                      device="cuda")
        out, V, m_top, top_i = phase(
            name, kernel, rr, scores, feats, None, window, "resident", 1,
            records, single=window is None, layout=line)
        d2 = init_gains(V, torch.ones(V.shape[0], V.shape[2], dtype=torch.bool,
                                      device=V.device))
        if window is None:
            kfn = lambda: dpp_greedy_resident(V, d2, k, EPS)  # noqa: E731
            pfn = lambda: dpp_greedy_resident_plain(V, d2, k, EPS)  # noqa
        else:
            kfn = lambda: dpp_greedy_resident_windowed(  # noqa: E731
                V, d2, k, window, EPS)
            pfn = lambda: dpp_greedy_resident_windowed_plain(  # noqa: E731
                V, d2, k, window, EPS)
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        check(torch.equal(
            torch.where(got[0] >= 0,
                        top_i.gather(1, got[0].long().clamp_min(0)), -1)
            .to(torch.int32), out[0]),
            f"{name}: direct kernel call differs from the main path")
        _, err = compare(name, V, None, got, want, window, EPS)
        ms = time_events(lambda: event_ms(kfn), TIMING_REPS)
        dev = device_ms(kfn, kernel, 1, cuda_name=RESIDENT_CUDA[kernel])
        plain_ms = time_events(lambda: event_ms(pfn), PLAIN_REPS)
        records[kernel]["calls_launches"] = 1
        host = ("" if dev is None else
                f"; the wrapper's host time {(ms - dev) * 1e3:.1f} us "
                f"(event less device time)")
        kernel_record(records, kernel, ms, plain_ms,
                      bound(B, D, C, k, window, (got[0] >= 0).sum(1)), err,
                      "one launch, CUDA events" + host, device=dev)
        if window is None:
            results["single request"] = single_request_sweep(
                V[:1], d2[:1], k, got)
        results[window] = (V, got, out)
        b = SHARDED_B_USERS
        refs.setdefault("b", {"V": V[:b], "m_top": None, "top_i": top_i[:b],
                              "out": {}})["out"][window] = (out[0][:b],
                                                            out[1][:b])
    refs["b"]["npz"] = save_request(refs["work"] / "phase16b.npz",
                                    scores[:SHARDED_B_USERS], feats, None)
    refs["b"]["npz1"] = save_request(refs["work"] / "phase17b.npz",
                                     scores[:1], feats, None)
    return scores, feats, results


def single_request_sweep(V, d2, k, batch):
    """One user's K1 slate (phase 1's lane 0) at 1, 2, 4 and 8 CTAs a
    cluster, each with its Cholesky rows in shared memory where they fit
    beside the rest and in device memory: each must equal the batch's
    lane 0 bit for bit; event and device time of one launch at each (the
    measurement behind the policy's layout for a single request).
    Returns the policy's (cluster size, event ms, device ms)."""
    from repro_torch.kernels.dpp_greedy.dpp_greedy import (
        cluster_capacity,
        dpp_greedy_resident,
    )
    from repro_torch.kernels.dpp_greedy.tiling import (
        SMEM_BUDGET_BYTES,
        cluster_smem_bytes,
    )

    M = V.shape[2]
    plan, line = cluster_line(D, M, k, False, 1)
    check(plan == (4, True, True), f"single request: expected clusters of 4 "
                                   f"CTAs with V and the Cholesky rows in "
                                   f"shared memory: {line}")
    print(f"  single request, policy: {line}", flush=True)
    times = {}
    for s in (1, 2, 4, 8):
        forced, _ = cluster_line(D, M, k, False, 1, s)
        for layout in (forced._replace(state_resident=False),
                       forced._replace(state_resident=True)):
            smem = cluster_smem_bytes(D, M, k, False, *layout)
            if smem > SMEM_BUDGET_BYTES:
                continue
            fn = lambda: dpp_greedy_resident(V, d2, k, EPS,  # noqa: E731
                                             plan=layout)
            got = fn()
            torch.cuda.synchronize()
            check(torch.equal(got[0], batch[0][:1])
                  and torch.equal(got[1], batch[1][:1]),
                  f"single request in {layout} differs from the batch")
            ms = time_events(lambda: event_ms(fn), TIMING_REPS)
            dev = device_ms(fn, "dpp_greedy_resident", 1,
                            cuda_name=RESIDENT_CUDA["dpp_greedy_resident"])
            cap = cluster_capacity(False, s, smem, layout.v_resident,
                                   layout.state_resident, V.device)
            print(f"  single request, "
                  f"{layout_text(layout, M, False, smem, cap)}: "
                  f"{ms:.4f} ms (CUDA events, median of {TIMING_REPS}), "
                  f"device time by torch.profiler {ms_text(dev)}; equals "
                  f"lane 0 of the batch bit for bit", flush=True)
            times[layout] = (ms, dev)
    return (plan.s, *times[plan])


def run_tiled(records, rng, refs):
    from repro_torch.kernels.dpp_greedy import tiled as tm
    from repro_torch.kernels.dpp_greedy.tiling import TilePolicy
    from repro_torch.serving import DPPRerankConfig, Reranker

    B, M, C = 4, 1_000_000, 65536
    scores, feats, mask = make_inputs(rng, B, M, seen_frac=0.1)
    base = dict(use_kernel=True, shortlist=C, alpha=ALPHA, eps=EPS)
    results = {}
    for name, kernel, k, window in (
        ("phase 3 tiled exact", "tiled_step_exact", 50, None),
        ("phase 4 tiled windowed", "tiled_step_windowed", 200, 10),
    ):
        rr = Reranker(DPPRerankConfig(slate_size=k, window=window, **base),
                      device="cuda")
        out, V, m_top, top_i = phase(
            name, kernel, rr, scores, feats, mask, window, "tiled", k,
            records, watch=window is not None)
        tile = TilePolicy().decide(D, C, window or k, windowed=window
                                   is not None)[1]
        # kernel vs plain: the same whole-slate loop with the plain steps
        got = tm.dpp_greedy_tiled(V, m_top, k, window, EPS, tile)
        with patched_steps(tm, plain=True):
            want = tm.dpp_greedy_tiled(V, m_top, k, window, EPS, tile)
        torch.cuda.synchronize()
        check(torch.equal(
            torch.where(got[0] >= 0,
                        top_i.gather(1, got[0].long().clamp_min(0)), -1)
            .to(torch.int32), out[0]),
            f"{name}: direct kernel call differs from the main path")
        _, err = compare(name, V, m_top, got, want, window, EPS)
        ms, plain_ms, span = time_tiled(tm, V, m_top, k, window, tile)
        dev = device_ms(lambda: tm.dpp_greedy_tiled(V, m_top, k, window, EPS,
                                                    tile), kernel, k)
        records[kernel]["calls_launches"] = k
        kernel_record(records, kernel, ms, plain_ms,
                      bound(B, D, C, k, window, (got[0] >= 0).sum(1)), err,
                      f"sum of {k} launches, CUDA events per launch",
                      device=dev)
        busy = ("" if dev is None else f"; device time is {dev / span:.1%} "
                f"of it, the rest the card waits for the host")
        print(f"  {kernel}: from before the first launch to after the last, "
              f"CUDA events: {span:.4f} ms{busy}", flush=True)
        stream_floor(B, C, k, dev, exact=window is None)
        results[window] = (V, m_top, got)
        refs.setdefault("a", {"V": V, "m_top": m_top, "top_i": top_i,
                              "out": {}, "direct": {},
                              "req": (scores, feats, mask)})
        refs["a"]["out"][window] = out
        refs["a"]["direct"][window] = got
    refs["a"]["npz"] = save_request(refs["work"] / "phase16a.npz", scores,
                                    feats, mask)
    return results, feats


@contextlib.contextmanager
def patched_steps(tm, plain=False, wrap=None):
    """Within the block, ``dpp_greedy_tiled``'s per-step function runs
    the plain step (``plain``) instead of the kernel's launch, and is
    wrapped as ``wrap(step)`` when given; the loop calls it once a step."""
    real = tm.step_launcher

    def launcher(kernel, operands, eps, tile):
        if plain:
            ref = getattr(tm, kernel + "_plain")
            step = lambda t: ref(*operands, t, eps, tile)  # noqa: E731
        else:
            step = real(kernel, operands, eps, tile)
        return step if wrap is None else wrap(step)

    tm.step_launcher = launcher
    try:
        yield
    finally:
        tm.step_launcher = real


def time_tiled(tm, V, mask, k, window, tile):
    """Kernel and plain time of one whole-slate tiled call as the sum of
    one CUDA event pair per step (each pair also holds the step
    function's host time: one ctypes call), and the kernel's span from
    one event right before the first step's launch to one right after
    the last (the loop issues nothing between its k launches)."""
    def run(plain=False, wrap=None):
        with patched_steps(tm, plain, wrap):
            tm.dpp_greedy_tiled(V, mask, k, window, EPS, tile)

    def summed(plain):
        def one():
            acc = []
            run(plain, lambda step: lambda t: acc.append(
                event_ms(lambda: step(t))))
            return sum(acc)
        return one

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def bracketed(step):
        def one(t):
            if t == 0:
                ev[0].record()
            step(t)
            if t == k - 1:
                ev[1].record()
        return one

    def span():
        run(wrap=bracketed)
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    return (time_events(summed(False), TIMING_REPS),
            time_events(summed(True), PLAIN_REPS),
            time_events(span, TIMING_REPS))


def run_forced_tile(resident_out, resident_V, scores, feats):
    from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

    rr = Reranker(DPPRerankConfig(use_kernel=True, shortlist=1000,
                                  slate_size=50, alpha=ALPHA, eps=EPS,
                                  tile_m=256), device="cuda")

    print("[phase 5 forced tile] phase 1 inputs, tile_m=256", flush=True)
    out, counts, modes = drive(rr, RerankRequest(scores=scores, feats=feats))
    check(counts == {"tiled_step_exact": 50},
          f"phase 5: launches {counts}, expected 50 tiled_step_exact")
    check(modes == {"mode=tiled,windowed=False": 1},
          f"phase 5: dispatch telemetry {modes}")
    check(torch.equal(out[0], resident_out[0]),
          "phase 5: tiled slate differs from the resident slate")
    err = (out[1] - resident_out[1]).abs().max().item()
    check(err == 0.0, f"phase 5: d_hist differs from resident by {err}")
    print(f"  launches {counts}; slate and d_hist equal phase 1's resident "
          f"ones bit for bit (d_hist max abs diff {err})", flush=True)
    # K3 alone at this shape (B = 64, C = 1000, 4 tiles of 256 a lane)
    from repro_torch.kernels.dpp_greedy import tiled as tm

    V = resident_V
    mask = torch.ones(V.shape[0], V.shape[2], dtype=torch.bool,
                      device=V.device)
    ms, plain_ms, span = time_tiled(tm, V, mask, 50, None, 256)
    dev = device_ms(lambda: tm.dpp_greedy_tiled(V, mask, 50, None, EPS,
                                                256), "tiled_step_exact", 50)
    print(f"  tiled_step_exact at this shape: {ms:.4f} ms for 50 launches "
          f"({ms / 50 * 1e3:.1f} us a launch; median of {TIMING_REPS}, CUDA "
          f"events per launch); device time by torch.profiler "
          f"{ms_text(dev)}; first to last launch {span:.4f} ms; plain "
          f"{plain_ms:.4f} ms", flush=True)
    return counts["tiled_step_exact"]


# ---------------------------------------------------------------------------
# Phases 6-9: resumable streaming on the fused chunk kernels (K5 / K6)
# ---------------------------------------------------------------------------


def drive_chunks(fn):
    """One streaming main-path run ``fn()`` with the launch counters and
    dispatch telemetry reset right before and read right after."""
    from repro_torch import obs
    from repro_torch.kernels import cuda

    obs.disable()
    obs.enable(obs.ObsConfig(enabled=True))
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda.launch_counts()
    modes = obs.registry().counter("dpp_kernel_dispatch_total")._snapshot()
    obs.disable()
    return out, counts, modes, wall


def stream_slate(V, mask, k, window, chunk, tile_m=None):
    """The concatenated ``greedy_map_chunks`` slate of V (B, D, M) on the
    kernel backend: (sel (B, k), d_hist (B, k))."""
    from repro_torch.core import GreedySpec, greedy_map_chunks

    spec = GreedySpec(k=k, window=window, backend="kernel", eps=EPS,
                      tile_m=tile_m)
    parts = list(greedy_map_chunks(spec, V=V, mask=mask, chunk_size=chunk))
    return (torch.cat([p.indices for p in parts], -1),
            torch.cat([p.d_hist for p in parts], -1))


def with_chunk_kernel(kernel, fn, plain=False, timed=False):
    """Run ``fn()`` with the port's chunk dispatch calling ``kernel``'s
    plain version instead of the kernel (``plain``), each launch
    bracketed by CUDA events (``timed``); returns (fn's result, summed
    device ms of the launches)."""
    from repro_torch.kernels.dpp_greedy import ops
    from repro_torch.kernels.dpp_greedy import tiled as tm

    real = getattr(ops, kernel)
    impl = real
    if plain:
        ref = getattr(tm, kernel + "_plain")
        # the plain versions take neither the tile nor K6's V residency
        keep = {"fused_chunk_exact": 7, "fused_chunk_windowed": 8}[kernel]
        impl = lambda *args: ref(*args[:keep])  # noqa: E731
    acc = []

    def call(*args):
        if not timed:
            return impl(*args)
        out = []
        acc.append(event_ms(lambda: out.append(impl(*args))))
        return out[0]

    setattr(ops, kernel, call)
    try:
        res = fn()
    finally:
        setattr(ops, kernel, real)
    return res, sum(acc)


def chunk_check(name, kernel, V, mask, k, window, chunk, record, records):
    """Kernel vs plain on the card for one streamed slate (certified as
    the whole-slate phases are), K5/K6 and their plain versions timed
    per launch with CUDA events over whole streams; ``record`` puts the
    numbers into the kernels' JSON record."""
    def run():
        return stream_slate(V, mask, k, window, chunk)

    got = run()
    want, _ = with_chunk_kernel(kernel, run, plain=True)
    torch.cuda.synchronize()
    _, err = compare(name, V, mask, got, want, window, EPS)
    n = -(-k // chunk)
    ms = time_events(
        lambda: with_chunk_kernel(kernel, run, timed=True)[1], TIMING_REPS)
    dev = device_ms(run, kernel, n)
    plain_ms = time_events(
        lambda: with_chunk_kernel(kernel, run, plain=True, timed=True)[1],
        PLAIN_REPS)
    B, _, M = V.shape
    bnd = bound(B, D, M, k, window, (got[0] >= 0).sum(1))
    print(f"  {kernel}: {ms:.4f} ms/slate = {ms / n:.4f} ms/chunk call "
          f"({n} launches, chunk {chunk}; median of {TIMING_REPS}, CUDA "
          f"events per launch); device time by torch.profiler "
          f"{ms_text(dev)}/slate (median of {TIMING_REPS // 4}); plain "
          f"{plain_ms:.4f} ms/slate, bound {bnd[0]:.4f} ms by {bnd[1]}",
          flush=True)
    stream_floor(B, M, k, dev, chunk_tiles(M, window or k, window is not None,
                                           B, V.device)[2],
                 exact=window is None)
    if record:
        records[kernel]["calls_launches"] = n
        kernel_record(records, kernel, ms, plain_ms, bnd, err,
                      f"sum of {n} chunk launches, CUDA events per launch",
                      device=dev)


def check_equal(name, got, want):
    """A streamed slate must equal the whole-slate kernel slate index for
    index and its d_hist bit for bit (the same per-column device code);
    returns the max abs d_hist difference, 0."""
    if not torch.equal(got[0], want[0]):
        lanes = (got[0] != want[0]).any(-1).nonzero()[:, 0].tolist() \
            if got[0].shape == want[0].shape else "all"
        check(False, f"{name}: streamed slate differs from the whole-slate "
                     f"slate in lanes {lanes}")
    err = (got[1] - want[1]).abs().max().item()
    check(err == 0.0, f"{name}: d_hist differs from the whole slate by {err}")
    print(f"  {name}: slate equals the whole-slate kernel slate index for "
          f"index; d_hist max abs diff {err} (bit for bit)", flush=True)
    return err


def count_chunks(records, name, counts, kernel, expect):
    check(counts == {kernel: expect},
          f"{name}: launches {counts}, expected {{{kernel!r}: {expect}}}")
    records.setdefault(kernel, {"launches": 0})["launches"] += expect


def run_stream(records, resident, scores, feats):
    from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

    k, chunk, C = 50, 8, 1000
    name = "phase 6 stream"
    line, nt, vres = chunk_tiles(C, k, False, 1, scores.device)
    check(vres and nt == 2, f"{name}: expected V in shared memory over two "
                            f"tiles: {line}")
    print(f"[{name}] Reranker.stream, pool {scores.shape[1]} shortlist {C} "
          f"k={k} chunk={chunk}: {line}", flush=True)
    rr = Reranker(DPPRerankConfig(slate_size=k, shortlist=C, alpha=ALPHA,
                                  eps=EPS, use_kernel=True), device="cuda")
    req = RerankRequest(scores=scores[0], feats=feats)

    def main():
        gen = rr.stream(req, chunk_size=chunk)
        return [c for c in gen]

    parts, counts, modes, wall = drive_chunks(main)
    count_chunks(records, name, counts, "fused_chunk_exact", -(-k // chunk))
    check(modes == {"mode=fused_chunk,windowed=False": 1},
          f"{name}: dispatch telemetry {modes}")
    sel = torch.cat([p[0] for p in parts])[None]
    dh = torch.cat([p[1] for p in parts])[None]
    n = check_outputs(name, (sel, dh), 1, k, scores.shape[1], None)
    print(f"  main path: {wall * 1e3:.1f} ms host wall, launches {counts}, "
          f"{len(parts)} chunks, {n} items selected", flush=True)
    out = resident[None][2]
    check_equal(name + " vs phase 1 (K1)", (sel, dh),
                (out[0][:1], out[1][:1]))
    V = resident[None][0][:1]
    chunk_check(name, "fused_chunk_exact", V, None, k, None, chunk, False,
                records)
    # where a single lane's time goes: the same slate as one K5 launch
    # (chunk = k) beside the seven chunk launches above and beside one K1
    # launch, phase 1's single request at the policy's cluster size
    k5_fn = lambda: stream_slate(V, None, k, None, k)  # noqa: E731
    one = time_events(lambda: with_chunk_kernel(
        "fused_chunk_exact", k5_fn, timed=True)[1], TIMING_REPS)
    k5_dev = device_ms(k5_fn, "fused_chunk_exact", 1)
    s, k1, k1_dev = resident["single request"]
    print(f"  one lane, whole slate: K1 {k1:.4f} ms (one launch, device "
          f"{ms_text(k1_dev)}: phase 1's single request at {s} CTAs a "
          f"cluster), K5 {one:.4f} ms (one launch, chunk {k}; device "
          f"{ms_text(k5_dev)})", flush=True)
    return sel, dh


def chunk_tiles(M, R, windowed, lanes, device):
    """The fused chunk kernel's tiling of ``lanes`` lanes of ``M``
    candidates and ``R`` state rows on this card and whether V stays in
    shared memory, as the wrappers get it (``ops._stream_tile``): (one
    line of text, tiles per lane, V in shared memory)."""
    from repro_torch.kernels.dpp_greedy.ops import _stream_tile
    from repro_torch.kernels.dpp_greedy.tiled import chunk_capacity
    from repro_torch.kernels.dpp_greedy.tiling import chunk_smem_bytes

    tile, vres = _stream_tile(D, M, R, windowed, None, lanes, device)
    smem = chunk_smem_bytes(D, tile, R, windowed, vres)
    cap = chunk_capacity(windowed, smem, device)
    nt = -(-M // tile)
    mode = ("V in shared memory" if vres else "V streamed") \
        + (", ring in shared memory" if windowed else "")
    return (f"{nt} tiles of {tile} per lane, {lanes * nt} cooperative "
            f"blocks, {smem} B of shared memory each ({mode}; the card "
            f"keeps {cap} co-resident at this size)"), nt, vres


def run_chunks_windowed(records, resident):
    k, w, chunk = 200, 10, 16
    V, k2, _ = resident[w]
    name = "phase 7 chunks windowed"
    B, _, C = V.shape
    line, nt, vres = chunk_tiles(C, w, True, B, V.device)
    check(vres and nt == 2, f"{name}: expected V in shared memory over two "
                            f"tiles per lane: {line}")
    print(f"[{name}] greedy_map_chunks B={B} shortlist {C} w={w} k={k} "
          f"chunk={chunk}: {line}", flush=True)
    got, counts, modes, wall = drive_chunks(
        lambda: stream_slate(V, None, k, w, chunk))
    count_chunks(records, name, counts, "fused_chunk_windowed",
                 -(-k // chunk))
    check(modes == {"mode=fused_chunk,windowed=True": 1},
          f"{name}: dispatch telemetry {modes}")
    print(f"  main path: {wall * 1e3:.1f} ms host wall, launches {counts}",
          flush=True)
    check_equal(name + " vs phase 2 (K2)", got, k2)
    chunk_check(name, "fused_chunk_windowed", V, None, k, w, chunk, False,
                records)


def run_chunks_large(records, tiled):
    chunk = 16
    for name, kernel, k, w in (
        ("phase 8 chunks large exact", "fused_chunk_exact", 50, None),
        ("phase 8 chunks large windowed", "fused_chunk_windowed", 200, 10),
    ):
        V, m_top, whole = tiled[w]
        B, _, C = V.shape
        line, nt, vres = chunk_tiles(C, w or k, w is not None, B, V.device)
        check(nt > 1 and not vres, f"{name}: expected several tiles per "
                                   f"lane with V streamed: {line}")
        print(f"[{name}] greedy_map_chunks B={B} shortlist {C} k={k} "
              f"window={w} chunk={chunk}: {line}", flush=True)
        got, counts, modes, wall = drive_chunks(
            lambda: stream_slate(V, m_top, k, w, chunk))
        count_chunks(records, name, counts, kernel, -(-k // chunk))
        print(f"  main path: {wall * 1e3:.1f} ms host wall (phase "
              f"{3 if w is None else 4}'s K3/K4 call is the comparison), "
              f"launches {counts}", flush=True)
        check_equal(f"{name} vs phase {3 if w is None else 4} "
                    f"({'K3' if w is None else 'K4'})", got, whole)
        chunk_check(name, kernel, V, m_top, k, w, chunk, True, records)


def run_slots(records, resident):
    from repro_torch.core import (
        GreedySpec,
        greedy_chunk_slots,
        greedy_slot_state,
        greedy_slots_init,
        slot_pad_v,
        state_splice,
    )

    k, chunk, late = 50, 8, 2
    V, _, _ = resident[None]
    S, _, M = V.shape
    name = "phase 9 slots"
    line, nt, vres = chunk_tiles(M, k, False, S, V.device)
    check(vres and nt == 2, f"{name}: expected V in shared memory over two "
                            f"tiles per slot: {line}")
    print(f"[{name}] greedy_chunk_slots S={S} M={M} k={k} chunk={chunk}; "
          f"slots {S // 2}..{S - 1} spliced after {late} chunks: {line}",
          flush=True)
    spec = GreedySpec(k=k, backend="kernel", eps=EPS)
    cycles = late + -(-k // chunk)

    def main():
        state, Vs = greedy_slots_init(spec, S, D, M, device="cuda")
        Vs.copy_(V)
        Vs = slot_pad_v(spec, Vs, state)
        sels = []
        for c in range(cycles):
            for b in range(S):
                if (b < S // 2 and c == 0) or (b >= S // 2 and c == late):
                    state = state_splice(
                        state, greedy_slot_state(spec, V[b]), b)
            state, sel, dh = greedy_chunk_slots(spec, state, Vs, chunk)
            sels.append((sel, dh))
        return sels

    first = torch.full((S,), late * chunk, device="cuda")
    first[:S // 2] = 0
    cols = first[:, None] + torch.arange(k, device="cuda")

    def slates(sels):
        """Each slot's k picks from its own first cycle on: (S, k)."""
        sel = torch.cat([x[0] for x in sels], 1)
        dh = torch.cat([x[1] for x in sels], 1)
        return sel.gather(1, cols), dh.gather(1, cols)

    sels, counts, modes, wall = drive_chunks(main)
    count_chunks(records, name, counts, "fused_chunk_exact", cycles)
    print(f"  main path: {wall * 1e3:.1f} ms host wall, launches {counts}",
          flush=True)
    got = slates(sels)
    # K5 against its plain version at the slot path's shapes: the same
    # splices and chunks, each launch replaced by fused_chunk_exact_plain
    plain, _ = with_chunk_kernel("fused_chunk_exact", main, plain=True)
    torch.cuda.synchronize()
    _, err = compare(name + " K5 vs plain", V, None, got, slates(plain),
                     None, EPS)
    rec = records["fused_chunk_exact"]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    ms = time_events(lambda: with_chunk_kernel(
        "fused_chunk_exact", main, timed=True)[1], TIMING_REPS)
    dev = device_ms(main, "fused_chunk_exact", cycles)
    print(f"  fused_chunk_exact at the slots' shape: {ms:.4f} ms for "
          f"{cycles} launches ({ms / cycles:.4f} ms a launch; median of "
          f"{TIMING_REPS}, CUDA events per launch); device time by "
          f"torch.profiler {ms_text(dev)}", flush=True)
    check_equal(name + " vs phase 1 (K1)", got, resident[None][1])
    want = [stream_slate(V[b:b + 1], None, k, None, chunk) for b in range(S)]
    want = (torch.cat([x[0] for x in want]), torch.cat([x[1] for x in want]))
    check_equal(name + " vs single-request streams", got, want)


def small_reference_check(rng):
    """The port's kernel path on the card against its plain torch path on
    the CPU, at a small size."""
    from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest
    from repro_torch.serving.reranker import _shortlist_kernel

    scores, feats, mask = make_inputs(rng, 3, 2000, seen_frac=0.1)
    for window, tile_m in ((None, None), (5, None), (None, 128), (5, 128)):
        kw = dict(shortlist=300, slate_size=24, alpha=ALPHA, eps=EPS,
                  window=window)
        gpu = Reranker(DPPRerankConfig(use_kernel=True, tile_m=tile_m, **kw),
                       device="cuda").rerank(RerankRequest(
                           scores=scores, feats=feats, mask=mask))
        cpu = Reranker(DPPRerankConfig(**kw), device="cpu").rerank(
            RerankRequest(scores=scores.cpu(), feats=feats.cpu(),
                          mask=mask.cpu()))
        cfg = DPPRerankConfig(**kw)
        V, m_top, top_i = _shortlist_kernel(scores, feats, cfg, mask)
        inv = torch.full((3, scores.shape[1]), -1, dtype=torch.long,
                         device="cuda")
        inv.scatter_(1, top_i, torch.arange(top_i.shape[1], device="cuda")
                     .expand_as(top_i).contiguous())

        def local(sel):
            sel = sel.to("cuda").long()
            return torch.where(sel >= 0, inv.gather(1, sel.clamp_min(0)), -1)

        compare(f"small reference window={window} tile_m={tile_m}", V,
                m_top, (local(gpu[0]), gpu[1]),
                (local(cpu[0]), cpu[1].to("cuda")), window, EPS)
        if tile_m is not None:
            continue
        # the stream of user 0: K5/K6 on the card vs the torch core on CPU
        req = RerankRequest(scores=scores[0], feats=feats, mask=mask[0])
        gpu = [torch.cat(x)[None] for x in zip(*Reranker(
            DPPRerankConfig(use_kernel=True, **kw), device="cuda").stream(
                req, chunk_size=7))]
        cpu = [torch.cat(x)[None].to("cuda") for x in zip(*Reranker(
            DPPRerankConfig(**kw), device="cpu").stream(RerankRequest(
                scores=scores[0].cpu(), feats=feats.cpu(),
                mask=mask[0].cpu()), chunk_size=7))]
        compare(f"small reference stream window={window}", V[:1], m_top[:1],
                (local(gpu[0]), gpu[1]), (local(cpu[0]), cpu[1]), window,
                EPS)


# ---------------------------------------------------------------------------
# Phases 10-12: DeepFM scoring into the rerank (K8, K1) and scored_topk (K7)
# ---------------------------------------------------------------------------


def serve_outputs(name, scores, slates, B, Mc, k):
    """Scores (B, Mc) finite in (0, 1); slates (B, k) of distinct
    candidate positions, a -1 tail only after an eps-stop.  Returns the
    number of items selected."""
    check(tuple(scores.shape) == (B, Mc) and scores.dtype == torch.float32,
          f"{name}: scores {tuple(scores.shape)} {scores.dtype}")
    check(bool(torch.isfinite(scores).all()), f"{name}: non-finite score")
    check(bool(((scores > 0) & (scores < 1)).all()),
          f"{name}: a score outside (0, 1)")
    check(tuple(slates.shape) == (B, k) and slates.dtype == torch.int32,
          f"{name}: slates {tuple(slates.shape)} {slates.dtype}")
    live = slates >= 0
    check(bool(live[:, 0].all()), f"{name}: a user got an empty slate")
    check(bool((slates < Mc).all()), f"{name}: id out of range")
    check(bool((live[:, :-1] | ~live[:, 1:]).all()),
          f"{name}: a pick after an eps-stop")
    srt = torch.sort(torch.where(live, slates, -1 - torch.arange(
        k, device=slates.device, dtype=slates.dtype)), 1).values
    check(bool((srt[:, 1:] != srt[:, :-1]).all()), f"{name}: repeated id")
    return int(live.sum())


def serve_phase(name, records, model, cfg, user, cand, rr, reps):
    """``reps`` main-path ``serve_batch`` calls, each with the counters
    and dispatch telemetry reset right before and read right after; K8
    must launch once per forward and K1 once per rerank."""
    from repro_torch.launch.serve import serve_batch

    walls, out = [], None
    for _ in range(reps):
        out, counts, modes, wall = drive_chunks(
            lambda: serve_batch(model, user, cand, cfg, rr))
        check(counts == {"fm_interaction": 1, "dpp_greedy_resident": 1},
              f"{name}: launches {counts}, expected one fm_interaction and "
              f"one dpp_greedy_resident")
        check(modes == {"mode=resident,windowed=False": 1},
              f"{name}: dispatch telemetry {modes}")
        for kernel, n in counts.items():
            records.setdefault(kernel, {"launches": 0})["launches"] += n
        walls.append(wall)
    return out, counts, walls


def run_recsys_serve(records):
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data import recsys_batches
    from repro_torch.kernels.fm_interaction import (
        fm_interaction,
        fm_interaction_ref,
    )
    from repro_torch.launch.serve import candidate_ids, report
    from repro_torch.models import recsys
    from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

    cfg = get_arch("deepfm").config
    B, Mc, C, k = RECSYS_SHAPES["serve_p99"].batch, 2000, 200, 10
    name = "phase 10 recsys serve"
    t0 = time.perf_counter()
    model = recsys.init_params(torch.Generator("cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.parameters())
    print(f"[{name}] deepfm {cfg.n_fields} fields, table "
          f"{tuple(model.table.shape)}, MLP {cfg.mlp_dims}: {nparam} "
          f"parameters ({4 * nparam / 1e9:.3f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; B={B} x {Mc} candidates "
          f"({B * Mc} scored rows), shortlist {C}, slate {k}", flush=True)
    user = torch.as_tensor(next(recsys_batches(cfg.vocab_sizes, B, seed=1))
                           ["ids"], device="cuda")
    cand = torch.arange(Mc, dtype=torch.int32, device="cuda")
    rr = Reranker(DPPRerankConfig(slate_size=k, shortlist=C, alpha=ALPHA,
                                  eps=EPS, use_kernel=True), device="cuda")
    (scores, slates), counts, walls = serve_phase(name, records, model, cfg,
                                                  user, cand, rr, 2)
    n = serve_outputs(name, scores, slates, B, Mc, k)
    with torch.inference_mode():
        feats = recsys.item_embeddings(model, cand, cfg)
        ids = candidate_ids(user, cand, cfg)
        emb, _ = recsys.embed(model, ids, cfg)
    rep = report("deepfm", scores, slates, feats, walls[0], walls[1])
    print(f"  main path: first batch {walls[0] * 1e3:.1f} ms, steady "
          f"{walls[1] * 1e3:.1f} ms host wall; launches per call {counts}; "
          f"{n} items selected; K1: "
          f"{cluster_line(cfg.embed_dim, C, k, False, B)[1]}", flush=True)
    print("  report " + json.dumps(rep), flush=True)

    # where a steady call's device time goes, stage by stage
    with torch.inference_mode():
        stages = {
            "embedding bags": lambda: recsys.embed(model, ids, cfg),
            "forward (scores)": lambda: recsys.serve_scores(model, ids, cfg),
            "rerank (shortlist + K1)": lambda: rr.rerank(RerankRequest(
                scores=scores, feats=feats)),
        }
        for stage, fn in stages.items():
            ms = time_events(lambda: event_ms(fn), PLAIN_REPS)
            print(f"  stage {stage}: {ms:.4f} ms (CUDA events, median of "
                  f"{PLAIN_REPS})", flush=True)

        # K8 against its plain version on the forward's own embeddings
        got, want = fm_interaction(emb), fm_interaction_ref(emb)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=FM_RTOL, atol=FM_ATOL),
              f"{name}: K8 differs from its plain version by {err}")
        print(f"  fm_interaction vs plain on emb {tuple(emb.shape)}: max abs "
              f"err {err:.3g} (rtol {FM_RTOL} / atol {FM_ATOL})", flush=True)
        ms = time_events(lambda: event_ms(lambda: fm_interaction(emb)),
                         TIMING_REPS)
        plain_ms = time_events(
            lambda: event_ms(lambda: fm_interaction_ref(emb)), PLAIN_REPS)
    N, F, Dm = emb.shape
    records["fm_interaction"]["calls_launches"] = 1
    kernel_record(records, "fm_interaction", ms, plain_ms,
                  bound_of(4 * N * F * Dm + 4 * N,
                           N * (3 * F * Dm + 3 * Dm + 1)),
                  err, "one launch, CUDA events", None,
                  "no single PyTorch call computes the FM term")
    return model, cfg, user[:4], cand, scores[:4], slates[:4], feats, rr.cfg


def run_retrieval(records, model, cfg):
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data import recsys_batches
    from repro_torch.launch.serve import report
    from repro_torch.models import recsys
    from repro_torch.serving import DPPRerankConfig, Reranker

    shape = RECSYS_SHAPES["retrieval_cand"]
    B, Mc, C, k = shape.batch, shape.n_candidates, 1000, 50
    name = "phase 11 retrieval"
    check(Mc <= cfg.vocab_sizes[cfg.item_field],
          f"{name}: the item field holds fewer than {Mc} ids")
    print(f"[{name}] B={B} x {Mc} candidates (item field of "
          f"{cfg.vocab_sizes[cfg.item_field]} ids), shortlist {C}, slate {k}",
          flush=True)
    user = torch.as_tensor(next(recsys_batches(cfg.vocab_sizes, B, seed=1))
                           ["ids"], device="cuda")
    cand = torch.arange(Mc, dtype=torch.int32, device="cuda")
    rr = Reranker(DPPRerankConfig(slate_size=k, shortlist=C, alpha=ALPHA,
                                  eps=EPS, use_kernel=True), device="cuda")
    (scores, slates), counts, walls = serve_phase(name, records, model, cfg,
                                                  user, cand, rr, 1)
    n = serve_outputs(name, scores, slates, B, Mc, k)
    with torch.inference_mode():
        feats = recsys.item_embeddings(model, cand, cfg)
    rep = report("deepfm", scores, slates, feats, walls[0], walls[0])
    print(f"  main path: {walls[0] * 1e3:.1f} ms host wall; launches "
          f"{counts}; {n} of {k} slots selected (the features have rank "
          f"{cfg.embed_dim}: past it the gains fall under eps); K1: "
          f"{cluster_line(cfg.embed_dim, C, k, False, B)[1]}", flush=True)
    print("  report " + json.dumps(rep), flush=True)


def recsys_reference_check(model, cfg, user, cand, scores, slates, feats,
                           rr_cfg):
    """Phase 10's first users through the same ``serve_batch`` on the CPU
    (the parameters moved there): scores within rtol 1e-5 / atol 1e-6;
    slates equal, or the shortlist differs only by a score near-tie at
    its boundary, or the greedy diverges at a float64-certified near-tie.
    Moves ``model`` to the CPU."""
    from repro_torch.launch.serve import serve_batch
    from repro_torch.serving import Reranker
    from repro_torch.serving.reranker import _shortlist_kernel

    name = "recsys reference check"
    B = user.shape[0]
    model.to("cpu")
    s_cpu, sl_cpu = serve_batch(model, user.cpu(), cand.cpu(), cfg,
                                Reranker(rr_cfg, device="cpu"))
    err = (scores.cpu() - s_cpu).abs().max().item()
    check(torch.allclose(scores.cpu(), s_cpu, rtol=SCORE_RTOL,
                         atol=SCORE_ATOL),
          f"{name}: scores differ from the CPU by {err}")
    same = [b for b in range(B) if torch.equal(slates[b].cpu(), sl_cpu[b])]
    C = min(rr_cfg.shortlist, cand.shape[0])
    for b in sorted(set(range(B)) - set(same)):
        V, _, top_i = _shortlist_kernel(scores[b:b + 1], feats, rr_cfg, None)
        _, _, top_c = _shortlist_kernel(s_cpu[b:b + 1], feats.cpu(), rr_cfg,
                                        None)
        g, c_ = set(top_i[0].tolist()), set(top_c[0].tolist())
        if g != c_:
            edge = scores[b, top_i[0, C - 1]].item()
            for x in g ^ c_:
                sx = scores[b, x].item()
                check(abs(sx - edge) <= SCORE_ATOL + SCORE_RTOL * abs(edge),
                      f"{name}: user {b} shortlists differ at {x} (score "
                      f"{sx}, boundary {edge}) without a near-tie")
            print(f"  user {b}: shortlists differ by a score near-tie at "
                  f"the boundary", flush=True)
            continue
        inv = {int(x): i for i, x in enumerate(top_i[0].tolist())}
        loc = [[inv[int(x)] if x >= 0 else -1 for x in sl.tolist()]
               for sl in (slates[b], sl_cpu[b])]
        got, want = (torch.tensor([x], device="cuda") for x in loc)
        certify(f"{name} user {b}", V, None, got, want, None, rr_cfg.eps)
    print(f"  {name}: {B} users, scores max abs err {err:.3g} (rtol "
          f"{SCORE_RTOL} / atol {SCORE_ATOL}); {len(same)} of {B} slates "
          f"equal index for index, the rest certified", flush=True)


def topk_check(name, vals, idx, rvals, ridx, s64):
    """K7 against the plain top-c: values within TK_TOL; an index may
    differ only where the two scores are within TK_TOL of each other (a
    float32 near-tie, certified in float64).  Returns the max abs value
    error."""
    err = (vals - rvals).abs().max().item()
    check(torch.allclose(vals, rvals, rtol=TK_TOL, atol=TK_TOL),
          f"{name}: values differ from the plain version by {err}")
    diff = (idx != ridx).nonzero()[:, 0]
    for p in diff.tolist():
        a, b = s64[int(idx[p])].item(), s64[int(ridx[p])].item()
        check(abs(a - b) <= TK_TOL * (1 + abs(b)),
              f"{name}: position {p} holds {int(idx[p])} (score {a}) where "
              f"the plain version has {int(ridx[p])} ({b})")
    return err, len(diff)


def topk_plan(emb, c, seg, label):
    """Print and return K7's launch plan for ``emb`` in segments of
    ``seg`` rows."""
    from repro_torch.kernels.scored_topk.scored_topk import plan_for

    p = plan_for(emb, c, seg)
    print(f"  {label} launch plan: {p.grid} CTAs = {p.segs} segments x "
          f"{p.ctas_per_seg}, tiles of {p.tile_rows} rows, ring of "
          f"{p.stages} stages, at most {p.key_slots} rows a CTA, keys "
          f"{'on chip' if p.keys_on_chip else 'in device memory'}, "
          f"{p.gather} gather slots a segment, {p.smem_bytes} B shared "
          f"memory a CTA, {p.scratch_bytes} B scratch", flush=True)
    return p


def topk_no_op_after(name, fn):
    """The global mode is one launch and nothing after it: no aten op
    once K7's launch is counted (a TorchDispatchMode), and no sort."""
    from repro_torch.kernels import cuda

    log = LaunchGapLog("scored_topk")
    cuda.reset_launch_counts()
    with log:
        fn()
    after = [op for op, n in log.ops if n >= 1]
    check(not after, f"{name}: aten ops after the K7 launch: {after[:5]}")
    check(not any("sort" in op for op, _ in log.ops),
          f"{name}: a sort among the call's ops")
    print(f"  one launch: the call's ops end at K7's launch ({len(log.ops)} "
          f"ops before it, none a sort)", flush=True)


def topk_pool(state):
    """Phase 3's pool (M = 10^6, D = 100 unit-norm rows) and phase 12's
    query, drawn again from the numpy generator ``state`` run_tiled drew
    them from."""
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    _, pool, _ = make_inputs(rng, 4, 1_000_000, seen_frac=0.1)
    q = torch.from_numpy(np.random.default_rng(SEED + 12).standard_normal(
        pool.shape[1], dtype=np.float32)).to("cuda")
    return pool, q


def topk_device_times(state_json):
    """``--topk-device-times STATE``: K7's torch.profiler device time at
    phase 12's timed shape, in a process of its own: once a process has
    profiled a thread-block-cluster launch (K1, phases 1-2) torch.profiler
    no longer sees K7's launches there (an H100 probe: 6 of 6 seen before,
    0 of 6 after).  Global mode, blocks mode and the ascending order of
    the same pool; the device activity and ops of one profiled global
    call; the pool's sum, so the caller can check the inputs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.scored_topk import (
        scored_topk,
        scored_topk_blocks,
    )

    pool, q = topk_pool(json.loads(state_json))
    c = 1000
    scored_topk(pool, q, c=c)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scored_topk(pool, q, c=c)
        torch.cuda.synchronize()
    out = {"pool_sum": pool.double().sum().item(),
           "activity": [kernel_base(e.name) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA],
           "sorts": [e.name for e in prof.events() if "sort" in e.name]}
    out["global"] = device_ms(lambda: scored_topk(pool, q, c=c),
                              "scored_topk", 1)
    out["blocks"] = device_ms(lambda: scored_topk_blocks(pool, q, c),
                              "scored_topk", 1)
    asc = pool[torch.argsort(pool.double() @ q.double())].contiguous()
    out["ascending"] = device_ms(lambda: scored_topk(asc, q, c=c),
                                 "scored_topk", 1)
    print("topk_device_times " + json.dumps(out), flush=True)


def topk_child(name, state, pool):
    """Run :func:`topk_device_times` in a child process on the same
    inputs (checked by the pool's sum) and check its device activity:
    one K7 kernel, no sort."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--topk-device-times",
         json.dumps(state)],
        capture_output=True, text=True, timeout=600)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("topk_device_times ")]
    check(res.returncode == 0 and lines,
          f"{name}: the device-time process failed: {res.stderr[-2000:]}")
    out = json.loads(lines[-1].split(" ", 1)[1])
    check(out["pool_sum"] == pool.double().sum().item(),
          f"{name}: the device-time process drew another pool")
    check(out["activity"] == ["scored_topk_kernel"] and not out["sorts"],
          f"{name}: one profiled call's device activity {out['activity']}, "
          f"sorts {out['sorts']}; expected one K7 kernel and no sort")
    print(f"  a fresh process on the same pool: one profiled call's device "
          f"activity is {out['activity']}, no sort among its ops; device "
          f"time global {ms_text(out['global'])}, blocks "
          f"{ms_text(out['blocks'])}, ascending {ms_text(out['ascending'])}",
          flush=True)
    return out


def run_scored_topk(records, pool, pool_state):
    from repro_torch.kernels.scored_topk import (
        scored_topk,
        scored_topk_blocks,
        scored_topk_blocks_plain,
        scored_topk_ref,
    )
    from repro_torch.kernels.scored_topk.scored_topk import block_rows

    def main_path(name, emb, q, c):
        out, counts, _, wall = drive_chunks(
            lambda: scored_topk(emb, q, c=c))
        check(counts == {"scored_topk": 1},
              f"{name}: launches {counts}, expected one scored_topk")
        records.setdefault("scored_topk", {"launches": 0})["launches"] += 1
        vals, idx = out
        M = emb.shape[0]
        check(tuple(vals.shape) == (c,) and tuple(idx.shape) == (c,),
              f"{name}: shapes {tuple(vals.shape)} {tuple(idx.shape)}")
        check(bool(torch.isfinite(vals).all()), f"{name}: non-finite value")
        check(bool(((idx >= 0) & (idx < M)).all()), f"{name}: id out of range")
        check(idx.unique().numel() == c, f"{name}: repeated id")
        check(bool((vals[1:] <= vals[:-1]).all()), f"{name}: not descending")
        print(f"  main path: {wall * 1e3:.2f} ms host wall, launches "
              f"{counts}", flush=True)
        return vals, idx

    g = torch.Generator("cuda").manual_seed(SEED)
    name = "phase 12 scored_topk exact ties"
    M, Dt, c = 100_000, 16, 1000
    e = torch.randint(-3, 4, (M, Dt), generator=g, device="cuda").float()
    q = torch.randint(-3, 4, (Dt,), generator=g, device="cuda").float()
    print(f"[{name}] M={M} D={Dt} c={c}, small-integer data", flush=True)
    topk_plan(e, c, M, "global mode")
    topk_plan(e, c, block_rows(M, c, 8192), "blocks mode")
    vals, idx = main_path(name, e, q, c)
    rvals, ridx = scored_topk_ref(e, q, c)
    check(torch.equal(idx, ridx) and torch.equal(vals, rvals),
          f"{name}: differs from the plain version")
    bv, bi = scored_topk_blocks(e, q, c)
    pv, pi = scored_topk_blocks_plain(e, q, c)
    check(torch.equal(bi, pi) and torch.equal(bv, pv),
          f"{name}: block survivors differ from the plain version")
    print(f"  {vals.unique().numel()} distinct values among the {c}: result "
          f"and {bi.shape[0]} blocks' survivors equal the plain version "
          f"index for index", flush=True)

    name = "phase 12 scored_topk timed"
    M, Dt = pool.shape
    q = torch.from_numpy(np.random.default_rng(SEED + 12).standard_normal(
        Dt, dtype=np.float32)).to("cuda")
    print(f"[{name}] phase 3's pool M={M} D={Dt}, c={c}, block_m 8192",
          flush=True)
    topk_plan(pool, c, M, "global mode")
    topk_plan(pool, c, block_rows(M, c, 8192), "blocks mode")
    vals, idx = main_path(name, pool, q, c)
    rvals, ridx = scored_topk_ref(pool, q, c)
    s64 = pool.double() @ q.double()
    err, moved = topk_check(name, vals, idx, rvals, ridx, s64)
    check(set(idx.tolist()) == set(ridx.tolist()),
          f"{name}: index sets differ from the plain version")
    bv, bi = scored_topk_blocks(pool, q, c)
    pv, pi = scored_topk_blocks_plain(pool, q, c)
    for r in range(bv.shape[0]):
        e_b, _ = topk_check(f"{name} block {r}", bv[r], bi[r], pv[r], pi[r],
                            s64)
        err = max(err, e_b)
    print(f"  values max abs err {err:.3g} (tolerance {TK_TOL}); the index "
          f"sets equal; {moved} positions swapped at float64-certified "
          f"near-ties", flush=True)
    topk_no_op_after(name, lambda: scored_topk(pool, q, c=c))
    times = topk_child(name, pool_state, pool)
    dev, blocks_dev = times["global"], times["blocks"]
    ms = time_events(lambda: event_ms(lambda: scored_topk(pool, q, c=c)),
                     TIMING_REPS)
    blocks_ms = time_events(
        lambda: event_ms(lambda: scored_topk_blocks(pool, q, c)), TIMING_REPS)
    plain_ms = time_events(
        lambda: event_ms(lambda: scored_topk_ref(pool, q, c)), PLAIN_REPS)
    lib_ms = time_events(
        lambda: event_ms(lambda: torch.topk(pool @ q, c)), TIMING_REPS)
    print(f"  blocks mode (scored_topk_blocks, {bv.shape[0]} segments of "
          f"8192 rows): {blocks_ms:.4f} ms by CUDA events, device "
          f"{ms_text(blocks_dev)}", flush=True)
    records["scored_topk"]["calls_launches"] = 1
    b = bound_of(4 * M * Dt + 4 * Dt + 8 * c, 2 * M * Dt)
    kernel_record(records, "scored_topk", ms, plain_ms, b, err,
                  "one launch, CUDA events", lib_ms,
                  "library call torch.topk(emb @ q, c)", device=dev)

    name = "phase 12 scored_topk ascending"
    asc = pool[torch.argsort(s64)].contiguous()  # scores ascend with the row
    print(f"[{name}] phase 3's pool permuted so that the scores ascend with "
          f"the row index, c={c}", flush=True)
    vals, idx = main_path(name, asc, q, c)
    rvals, ridx = scored_topk_ref(asc, q, c)
    a64 = asc.double() @ q.double()
    e_a, moved = topk_check(name, vals, idx, rvals, ridx, a64)
    check(set(idx.tolist()) == set(ridx.tolist()),
          f"{name}: index sets differ from the plain version")
    asc_ms = time_events(lambda: event_ms(lambda: scored_topk(asc, q, c=c)),
                         TIMING_REPS)
    asc_dev = times["ascending"]
    records["scored_topk"]["max_abs_err"] = max(
        records["scored_topk"]["max_abs_err"], e_a)
    print(f"  index sets equal, values max abs err {e_a:.3g}; "
          f"{asc_ms:.4f} ms by CUDA events, device {ms_text(asc_dev)} "
          f"(random order: {ms:.4f} / {ms_text(dev)})", flush=True)
    del asc

    name = "phase 12 scored_topk ragged"
    M, Dt, c = 1_000_003, 10, 128
    e = torch.randn((M, Dt), generator=g, device="cuda")
    q = torch.randn((Dt,), generator=g, device="cuda")
    print(f"[{name}] M={M} D={Dt} c={c}", flush=True)
    topk_plan(e, c, M, "global mode")
    vals, idx = main_path(name, e, q, c)
    rvals, ridx = scored_topk_ref(e, q, c)
    err, _ = topk_check(name, vals, idx, rvals, ridx, e.double() @ q.double())
    check(bool((idx < M).all()), f"{name}: an id past M")
    records["scored_topk"]["max_abs_err"] = max(
        records["scored_topk"]["max_abs_err"], err)
    print(f"  no id past M; values max abs err {err:.3g}", flush=True)


# ---------------------------------------------------------------------------
# Phase 13: the paper's experiments (repro_torch.figures) on the card
# ---------------------------------------------------------------------------


def figure_run(name, fn):
    """One figure's ``main`` on the card, with the launch counters reset
    right before and read right after: (its result, the counts)."""
    from repro_torch.kernels import cuda

    print(f"  -- {name}", flush=True)
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    print(f"  {name}: {time.perf_counter() - t0:.1f} s host wall, launches "
          f"{counts}", flush=True)
    return out, counts


def fig1_check(name, rows, V, numpy_Ns):
    """Every fast slate (the torch core, K1) and the card's float64
    slogdet slate against the float64 naive slate (numpy where it ran,
    else the card's float64 slogdet), index for index up to a certified
    near-tie; prints the speedups."""
    differ = []
    for row in rows:
        N, sl = row["N"], row["slates"]
        check((row["t_naive"] is not None) == (N in numpy_Ns),
              f"{name}: numpy naive greedy ran at N={N}: {row['t_naive']}")
        ref_name = "naive" if "naive" in sl else "naive_slogdet"
        ref = torch.as_tensor(sl[ref_name])[None]
        for path in ("naive_slogdet", "divdpp", "divdpp_kernel"):
            if path == ref_name:
                continue
            got = torch.as_tensor(sl[path])[None]
            check(tuple(got.shape) == (1, N) and bool((got >= 0).all()),
                  f"{name} N={N}: {path} slate {got}")
            if certify(f"{name} N={N} {path} vs {ref_name}", V[None], None,
                       got, ref, None, 1e-6):
                differ.append((N, path))
        speed = [f"{path} {row[t] * 1e3:.4f} ms" for path, t in (
            ("numpy naive", "t_naive"), ("card slogdet naive", "t_slogdet"),
            ("torch core", "t_core"), ("K1", "t_kernel"))
            if row[t] is not None]
        sp = [f"{fast} {row[slow] / row[t]:.1f}x over {label}"
              for fast, t in (("torch core", "t_core"), ("K1", "t_kernel"))
              for label, slow in (("numpy", "t_naive"),
                                  ("slogdet", "t_slogdet"))
              if row[slow] is not None]
        print(f"  fig1 N={N}: {', '.join(speed)}; {'; '.join(sp)}; "
              f"reference {ref_name}", flush=True)
    print(f"  {name}: {len(rows)} N, every fast slate equals the float64 "
          f"naive slate index for index"
          + (f" except {differ}, certified float64 near-ties" if differ
             else ""), flush=True)
    return differ


def fig3_check(name, card, cpu):
    """The card's Figure-3 rows against the port's CPU rows, user by
    user: MMR, greedy-avg and random slates equal; a Div-DPP slate may
    part from the CPU's only at a float64-certified near-tie; the rows of
    equal slates equal."""
    from repro_torch.core import build_kernel_dense
    from repro_torch.figures import fig3_tradeoff as f3

    differ = {}
    for data, (rows, det) in card.items():
        c_rows, c_det = cpu[data]
        check([r[0] for r in rows] == [r[0] for r in c_rows]
              and np.array_equal(det["users"], c_det["users"]),
              f"{name} {data}: rows or users differ from the CPU run")
        for (algo, rec, div), (_, c_rec, c_div) in zip(rows, c_rows):
            got, want = det["slates"][algo], c_det["slates"][algo]
            users = [i for i in range(got.shape[0])
                     if not np.array_equal(got[i], want[i])]
            if not users:
                check(rec == c_rec and div == c_div,
                      f"{name} {data} {algo}: equal slates, other rows")
                continue
            check(algo.startswith("divdpp_a"),
                  f"{name} {data} {algo}: {len(users)} users' slates differ "
                  f"from the CPU's")
            alpha = float(algo[len("divdpp_a"):])
            for i in users:
                cand, rel = det["cands"][int(det["users"][i])]
                L64 = build_kernel_dense(
                    torch.as_tensor(f3.normalize(rel)).double(),
                    torch.as_tensor(det["S"][np.ix_(cand, cand)]).double(),
                    alpha=alpha)
                a, r = (np.where(s >= 0, np.searchsorted(cand, s), -1)
                        for s in (got[i], want[i]))
                u = int(det["users"][i])
                p, x, y, gx, gy = certify_lane(
                    f"{name} {data} {algo} user {u}", dense_gains(L64), a,
                    r, f3.DPP_EPS)
                print(f"  {data} {algo} user {u} ({cand.size} candidates, "
                      f"N = {got.shape[1]}): the card's slate parts from "
                      f"the CPU's at step {p}, local {x} vs {y}, float64 "
                      f"gains {gx!r} vs {gy!r}", flush=True)
            differ[(data, algo)] = len(users)
            print(f"  {data} {algo}: {len(users)} users' slates part from "
                  f"the CPU's at certified float64 near-ties; card recall "
                  f"{rec:.4f} avg {div['avg']:.4f}, CPU recall {c_rec:.4f} "
                  f"avg {c_div['avg']:.4f}", flush=True)
    print(f"  {name}: every card row equals the port's CPU row"
          + (f" but {differ} (certified users)" if differ else ""),
          flush=True)
    return differ


def float64_stop(V, slate, window, eps):
    """The first step at which the float64 greedy on V (D, M), given
    ``slate``'s picks before it, has no gain above eps^2, where it would
    stop; ``len(slate)`` if it never would."""
    eps2 = float(np.float32(eps) * np.float32(eps))
    V64 = V.double()
    diag = (V64 * V64).sum(0)
    mask = torch.ones(V.shape[1], dtype=torch.bool, device=V.device)
    for p in range(len(slate)):
        pre = torch.as_tensor(slate[:p], dtype=torch.long, device=V.device)
        if _gains64(V64, diag, mask, pre, window).max().item() <= eps2:
            return p
    return len(slate)


def fig4_check(name, rows, grows):
    """Figure 4 on the card: every N-sweep slate (K2 windowed, K1 exact,
    K1 at N = w) against the torch core's on the same V, up to a
    certified near-tie, and ``win_step_vs_N`` printed; the gate sweep has
    a past-the-gate cell that ran K4 once a step.  (The figure itself
    raises on a gate cell's parity.)"""
    from repro_torch.core import GreedySpec, greedy_map
    from repro_torch.figures import fig4_windowed as f4

    M, D, _ = f4.FAST_SWEEP
    V = f4.setup(M, D, device="cuda")
    differ, past_rank = [], []
    for N, w, _, _, sl in rows:
        for path, window in (("windowed", w), ("exact", None)):
            core = greedy_map(GreedySpec(k=N, window=window, eps=f4.EPS,
                                         backend="torch"), V=V)
            got, want = torch.as_tensor(sl[path]), core.indices.cpu()
            n = int((got >= 0).sum())
            check(tuple(got.shape) == (N,) and bool((got[n:] == -1).all())
                  and got[:n].unique().numel() == n
                  and bool(((got[:n] >= 0) & (got[:n] < M)).all()),
                  f"{name} N={N}: {path} slate {got}")
            stop = N
            if not torch.equal(got.long(), want.long()):
                stop = float64_stop(V, want.numpy(), window, f4.EPS)
            if stop < N:
                # past the float64 stop every gain is rounding noise, so
                # the float32 picks there have no reference to agree with
                past_rank.append((N, path, stop))
                print(f"  fig4 N={N} {path}: the float64 greedy stops at "
                      f"step {stop} (no gain above eps^2 = {f4.EPS ** 2:g}); "
                      f"the float32 slates of K1 and the torch core go on "
                      f"on noise (the torch core's d^2 there "
                      f"{core.d_hist[stop].item():.4g}) and part at step "
                      f"{int(np.nonzero((got != want).numpy())[0][0])}",
                      flush=True)
            if certify(f"{name} N={N} {path} kernel vs torch core", V[None],
                       None, got[None, :stop], want[None, :stop], window,
                       f4.EPS):
                differ.append((N, path))
    base = rows[0][2] / rows[0][0]
    print("  fig4 win_step_vs_N8: " + ", ".join(
        f"N={N} {t / N / base:.2f}x ({t / N * 1e6:.2f} us a step; exact "
        f"{te / N * 1e6:.2f})" for N, _, t, te, _ in rows), flush=True)
    print(f"  {name}: every N-sweep kernel slate equals the torch core's"
          + (f" up to the float64 stop in {past_rank}" if past_rank else "")
          + (f" but {differ}, certified float64 near-ties" if differ
             else ""), flush=True)
    past = [g for g in grows if g["past_gate"]]
    check(past and all(g["mode"] == "tiled" and g["launches"] == {
        "tiled_step_windowed": g["k"]} for g in past),
        f"{name}: no past-the-gate cell ran K4 once a step: {past}")
    for g in grows:
        print(f"  fig4 gate M={g['M']} D={g['D']} w={g['w']}: past_gate="
              f"{g['past_gate']} mode={g['mode']} tile_m={g['tile_m']} "
              f"launches {g['launches']} parity={g['parity']}; kernel "
              f"{g['t_kernel'] * 1e3:.4f} ms, torch core "
              f"{g['t_torch'] * 1e3:.4f} ms", flush=True)


def fig6_check(name, rows):
    """Figure 6 on the card: the kernel row's whole (K4) and streamed (K6)
    slates against the torch row's slate for the same request, up to a
    certified near-tie.  (The figure itself raises on stream != whole,
    on a first chunk no earlier than the whole slate and on a K6 count
    other than one a chunk.)"""
    from repro_torch.figures import fig6_streaming as f6
    from repro_torch.serving import DPPRerankConfig
    from repro_torch.serving.reranker import _shortlist_kernel

    torch_row, kernel_row = rows
    M, D, N, w = (kernel_row[k] for k in ("M", "D", "N", "w"))
    scores, feats = f6.setup(M, D, device="cuda")
    V, _, top_i = _shortlist_kernel(scores[None], feats, DPPRerankConfig(
        slate_size=N, shortlist=M, alpha=f6.ALPHA, eps=f6.EPS, window=w),
        None)
    local = torch.empty(M, dtype=torch.long)
    local[top_i[0].cpu()] = torch.arange(M)

    def to_local(s):
        s = torch.as_tensor(s, dtype=torch.long)
        return torch.where(s >= 0, local[s.clamp_min(0)], -1)[None]

    want = to_local(torch_row["slate"])
    for path, label in (("slate", "whole (K4)"), ("streamed", "streamed (K6)")):
        lanes = certify(f"{name} kernel row {label} vs torch row", V, None,
                        to_local(kernel_row[path]), want, w, f6.EPS)
        print(f"  fig6 kernel row's {label} slate "
              + ("parts from the torch row's at a certified float64 "
                 "near-tie" if lanes else "equals the torch row's"),
              flush=True)
    for row in rows:
        print(f"  fig6 {row['name']}: first chunk "
              f"{row['t_first'] * 1e3:.4f} ms, whole slate "
              f"{row['t_whole'] * 1e3:.4f} ms "
              f"({row['t_first'] / row['t_whole']:.2f}x), whole stream "
              f"{row['t_total'] * 1e3:.4f} ms, K6 launches a chunk "
              f"{row['fused_calls_per_chunk']}", flush=True)


def run_paper_experiments(records):
    """Phase 13: Figures 1, 2, 3, 4 and 6 of ``repro_torch.figures`` and
    the quickstart on the card, each through its ``main`` (the figure's
    CSV is printed), checked here against float64 or the CPU."""
    from repro_torch.core import (
        GreedySpec,
        greedy_avg_select,
        greedy_map,
        mmr_select,
        scaled_features,
    )
    from repro_torch.examples import quickstart
    from repro_torch.figures.common import paper_setup
    from repro_torch.figures import (
        fig1_speedup as f1,
        fig2_reference as f2,
        fig3_tradeoff as f3,
        fig4_windowed as f4,
        fig6_streaming as f6,
    )

    name = "phase 13 paper experiments"
    print(f"[{name}] fig1 (N = 5..50, numpy naive to N = 20), fig2 "
          f"(N = 5..50), fig3, fig4 and fig6 at their --smoke sizes, the "
          f"quickstart", flush=True)
    t0 = time.perf_counter()
    total = {}

    def count(fig, counts, expect):
        check(set(counts) == set(expect) and all(counts.values()),
              f"{name} {fig}: launches {counts}, expected each of "
              f"{sorted(expect)}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    rows, counts = figure_run("fig1", lambda: f1.main(
        fast_mode=False, device="cuda", numpy_Ns=f1.FAST_NS))
    count("fig1", counts, {"dpp_greedy_resident"})
    _, V, _ = f1.setup(device="cuda")
    fig1_check(f"{name} fig1", rows, V, f1.FAST_NS)

    rows, counts = figure_run("fig2", lambda: f2.main(
        fast_mode=False, device="cuda"))
    count("fig2", counts, {"dpp_greedy_resident"})
    r, S, _, V = paper_setup(device="cuda")
    rc, Sc = r.cpu(), S.cpu()
    for row in rows:
        N, sl, t = row["N"], row["slates"], row["times"]
        for path, fn in (("mmr", mmr_select), ("greedy", greedy_avg_select)):
            check(np.array_equal(sl[path], fn(rc, Sc, N, f2.THETA).numpy()),
                  f"{name} fig2 N={N}: {path} on the card differs from the "
                  f"CPU")
        certify(f"{name} fig2 N={N} K1 vs torch core", V[None], None,
                torch.as_tensor(sl["divdpp_kernel"])[None],
                torch.as_tensor(sl["divdpp"])[None], None, 1e-6)
        print(f"  fig2 N={N}: MMR {t['mmr'] * 1e3:.4f} ms, greedy-avg "
              f"{t['greedy'] * 1e3:.4f} ms, Div-DPP torch core "
              f"{t['divdpp'] * 1e3:.4f} ms ({t['divdpp'] / t['mmr']:.2f}x "
              f"MMR), K1 {t['divdpp_kernel'] * 1e3:.4f} ms "
              f"({t['divdpp_kernel'] / t['mmr']:.2f}x MMR); MMR and "
              f"greedy-avg equal the CPU's slates", flush=True)

    card, counts = figure_run("fig3", lambda: f3.main(
        fast_mode=True, device="cuda"))
    check(counts == {}, f"{name} fig3: launches {counts}, expected none "
                        f"(the dense torch core)")
    fig3_check(f"{name} fig3", card, f3.run(fast_mode=True, device="cpu"))

    (rows, grows), counts = figure_run("fig4", lambda: f4.main(
        fast_mode=True, device="cuda"))
    count("fig4", counts, {"dpp_greedy_resident",
                           "dpp_greedy_resident_windowed",
                           "tiled_step_windowed"})
    fig4_check(f"{name} fig4", rows, grows)

    rows, counts = figure_run("fig6", lambda: f6.main(
        fast_mode=True, device="cuda"))
    count("fig6", counts, {"tiled_step_windowed", "fused_chunk_windowed"})
    fig6_check(f"{name} fig6", rows)

    slates, counts = figure_run("quickstart", lambda: quickstart.main("cuda"))
    count("quickstart", counts, {"dpp_greedy_resident"})
    check(counts["dpp_greedy_resident"] == len(quickstart.ALPHAS),
          f"{name} quickstart: {counts}")
    relevance, feats = quickstart.setup("cuda")
    for alpha, sel in slates.items():
        V = scaled_features(feats, relevance, alpha)
        want = greedy_map(GreedySpec(k=quickstart.N, backend="torch"),
                          V=V).indices
        lanes = certify(f"{name} quickstart alpha={alpha} K1 vs torch core",
                        V[None], None, torch.as_tensor(sel)[None],
                        want[None], None, 1e-6)
        print(f"  quickstart alpha={alpha}: K1's slate "
              + ("parts from the torch core's at a certified float64 "
                 "near-tie" if lanes else "equals the torch core's"),
              flush=True)

    for k, n in total.items():
        records.setdefault(k, {"launches": 0})["launches"] += n
    print(f"  {name}: launches {total}; {time.perf_counter() - t0:.1f} s "
          f"host wall", flush=True)


# ---------------------------------------------------------------------------
# Phase 14: the continuous-batching router (K5 / K6, K8) on the card
# ---------------------------------------------------------------------------

PUMP_SPANS = ("sync", "evict", "admit", "launch", "materialize")


def router_requests(rng, catalog, n, k_lo, k_hi, lapsed):
    """``n`` single requests over the first M rows of ``catalog`` (M, D)
    on the card: M log-uniform in [500, 100,000] (some narrower than the
    1000-column bucket), uniform scores, k in [k_lo, k_hi], a 10% seen
    mask every third request, an already-lapsed deadline (1e-9 s) on the
    requests ``lapsed``."""
    from repro_torch.serving import RerankRequest

    reqs = []
    for i in range(n):
        M = int(np.exp(rng.uniform(np.log(500), np.log(100_000))))
        scores = rng.uniform(size=M).astype(np.float32)
        mask = rng.uniform(size=M) >= 0.1 if i % 3 == 2 else None
        reqs.append(RerankRequest(
            scores=torch.from_numpy(scores).to("cuda"), feats=catalog[:M],
            mask=None if mask is None else torch.from_numpy(mask).to("cuda"),
            slate_size=int(rng.integers(k_lo, k_hi + 1)),
            deadline=1e-9 if i in lapsed else None, rid=i))
    return reqs


def drive_router(rr, reqs, burst, per_pump):
    """The router's main path: ``burst`` requests submitted at once, then
    ``per_pump`` more before each pump, then pumps to the end.  Returns
    (handles, peak slot occupancy, [chunk N+1 still running when chunk N
    was delivered, for each pump that delivered one and launched the
    next])."""
    router = rr.router
    handles = [rr.submit(r) for r in reqs[:burst]]
    pending, peak, overlap, launched = list(reqs[burst:]), 0, [], 0
    while pending or not all(h.done for h in handles):
        for r in pending[:per_pump]:
            handles.append(rr.submit(r))
        del pending[:per_pump]
        router.pump()
        running = router.chunk_running  # read first: the card runs on
        st = router.stats
        if st.chunks_launched > launched > 0:
            overlap.append(running)
        launched = st.chunks_launched
        peak = max(peak, st.slot_occupancy)
    return handles, peak, overlap


def router_run(fn):
    """One router main-path run ``fn()`` with the launch counters, the
    dispatch telemetry and a fresh observability session (metrics, spans,
    rebuilds) set right before and read right after: (fn's result, the
    launches, the kernel modes, the spans, the rebuild counters, host
    wall)."""
    from repro_torch import obs
    from repro_torch.kernels import cuda
    from repro_torch.obs.dispatch import REBUILD_COUNTERS

    obs.disable()
    obs.enable(obs.ObsConfig(enabled=True))
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda.launch_counts()
    reg = obs.registry()
    modes = reg.counter("dpp_kernel_dispatch_total")._snapshot()
    rebuilds = {name: reg.counter(name).total() for name in REBUILD_COUNTERS}
    spans = obs.tracer().finished()
    obs.disable()
    return out, counts, modes, spans, rebuilds, wall


def to_local(top_i, ids):
    """Global candidate ids (numpy, -1 after a stop) -> positions in the
    shortlist ``top_i`` (C,) on the card."""
    inv = {int(x): i for i, x in enumerate(top_i.tolist())}
    return torch.tensor([[inv[int(x)] if x >= 0 else -1 for x in ids]],
                        device="cuda")


def hold_slate(name, rr, req, got, want, window, bitwise):
    """One router slate ``got`` against ``want`` ((ids, d_hist) numpy,
    global ids): equal ids, or parting at a float64-certified near-tie
    (``certify`` on the request's shortlist kernel); d_hist over the
    agreeing prefix bit for bit (``bitwise``) or within rtol/atol.
    Returns (diverged, max abs d_hist difference)."""
    from repro_torch.serving.reranker import _shortlist_kernel

    (gi, gd), (ei, ed) = got, want
    p = len(gi) if np.array_equal(gi, ei) else int(np.nonzero(gi != ei)[0][0])
    if p < len(gi):
        cfg = rr.router._cfg_for(req)
        mask = None if req.mask is None else req.mask[None]
        V, m, top_i = _shortlist_kernel(req.scores[None], req.feats, cfg,
                                        mask)
        certify(name, V, m, to_local(top_i[0], gi), to_local(top_i[0], ei),
                window, EPS)
        print(f"  {name}: parts at step {p} ({gi[p]} vs {ei[p]}) at a "
              f"certified float64 near-tie", flush=True)
    err = float(np.abs(gd[:p] - ed[:p]).max()) if p else 0.0
    if bitwise:
        check(err == 0.0, f"{name}: d_hist differs by {err} where the ids "
                          f"agree")
    else:
        check(np.allclose(gd[:p], ed[:p], rtol=RTOL, atol=ATOL),
              f"{name}: d_hist beyond rtol {RTOL} / atol {ATOL} ({err})")
    return p < len(gi), err


def pump_split(spans):
    """Mean host microseconds a pump, of ``router.pump`` and each child
    span, from the tracer's spans."""
    pumps = [s["dur_us"] for s in spans if s["name"] == "router.pump"]
    parts = {p: sum(s["dur_us"] for s in spans
                    if s["name"] == f"router.pump.{p}") / len(pumps)
             for p in PUMP_SPANS}
    return statistics.fmean(pumps), parts, len(pumps)


def run_router_phase(records, rng, catalog, part, window, cap, k_lo, k_hi,
                     chunk):
    """Phase 14 (a) exact or (b) windowed: 192 requests through
    ``Reranker.submit`` on 64 slots, held against the per-request
    ``rerank`` (K1 / K2) and against the router on the plain chunk
    version; counters, lifecycle and rebuilds checked; K5 / K6 device
    time a launch."""
    from repro_torch.serving import DPPRerankConfig, Reranker, RouterConfig

    n, slots, burst, per_pump, bucket = 192, 64, 64, 8, 1000
    lapsed = set(int(x) for x in rng.choice(n, size=4, replace=False))
    kernel = "fused_chunk_exact" if window is None else "fused_chunk_windowed"
    name = f"phase 14({part}) router {'exact' if window is None else 'windowed'}"
    reqs = router_requests(rng, catalog, n, k_lo, k_hi, lapsed)
    cfg = DPPRerankConfig(slate_size=cap, shortlist=bucket, alpha=ALPHA,
                          eps=EPS, window=window, use_kernel=True)
    rcfg = RouterConfig(slots=slots, chunk_size=chunk, max_queue=n,
                        max_candidates=bucket)
    line = chunk_tiles(bucket, window or cap, window is not None, slots,
                       catalog.device)[0]
    widths = [min(r.num_candidates, bucket) for r in reqs]
    print(f"[{name}] {n} requests (pools {min(r.num_candidates for r in reqs)}"
          f"..{max(r.num_candidates for r in reqs)}, "
          f"{sum(w < bucket for w in widths)} narrower than the bucket; k in "
          f"[{k_lo}, {k_hi}]; a seen mask every third; deadlines lapsed: "
          f"{sorted(lapsed)}), {slots} slots, capacity {cap}, bucket "
          f"{bucket}, chunk {chunk}, window {window}; the first {burst} in a "
          f"burst, then {per_pump} a pump: {line}", flush=True)

    def main():
        rr = Reranker(cfg, router_config=rcfg, device="cuda")
        return rr, drive_router(rr, reqs, burst, per_pump)

    (rr, (handles, peak, overlap)), counts, modes, spans, rebuilds, wall = \
        router_run(main)
    st = rr.router.stats
    launches = st.chunks_launched
    busy = sum(1 for s in spans if s["name"] == "router.pump.launch"
               and s["attrs"]["lanes"] > 0)
    check(counts == {kernel: launches} and busy == launches,
          f"{name}: launches {counts}, router_chunks_launched_total "
          f"{launches}, pumps with active lanes {busy}")
    check(modes == {f"mode=fused_chunk,windowed={window is not None}": 1},
          f"{name}: dispatch telemetry {modes}, expected the slot batch's "
          f"one fused_chunk decision (admission writes a lane in place)")
    check(rebuilds == {"kernel_builds_total": 0,
                       "kernel_module_loads_total": 0,
                       "slot_state_allocs_total": 1},
          f"{name}: rebuilds {rebuilds}: expected no build or load and the "
          f"router's one slot-state allocation")
    records.setdefault(kernel, {"launches": 0})["launches"] += launches

    # every slate against the per-request rerank (K1 / K2) on the card
    ref = [tuple(x.cpu().numpy() for x in rr.rerank(r)) for r in reqs]
    stops = sum(1 for i, (ei, _) in enumerate(ref)
                if i not in lapsed and (ei < 0).any())
    want = dict(submitted=n, admitted=n - len(lapsed),
                completed=n - len(lapsed), timed_out=len(lapsed),
                eps_stopped=stops, rejected=0)
    got = {key: getattr(st, key) for key in want}
    check(got == want, f"{name}: lifecycle {got}, the inputs force {want}")
    diverged = 0
    for i, (h, r) in enumerate(zip(handles, reqs)):
        if i in lapsed:
            check(h.timed_out and len(h.slate()[0]) == 0,
                  f"{name}: request {i} (lapsed) was served")
            continue
        check(h.done and not h.timed_out, f"{name}: request {i} not served")
        diverged += hold_slate(f"{name} request {i}", rr, r, h.slate(),
                               ref[i], window, True)[0]
    print(f"  main path: {wall * 1e3:.1f} ms host wall, launches {counts} "
          f"(one a pump with active lanes), lifecycle {got}; rebuilds "
          f"{rebuilds}; {n - len(lapsed) - diverged} of {n - len(lapsed)} "
          f"slates equal the per-request rerank ({'K1' if window is None else 'K2'}) "
          f"index for index, d_hist bit for bit, the rest certified",
          flush=True)

    # the kernel run's slates against the same router on the plain version
    (_, (plain, _, _)), _ = with_chunk_kernel(kernel, main, plain=True)
    torch.cuda.synchronize()
    err = 0.0
    for i, (h, p) in enumerate(zip(handles, plain)):
        if i not in lapsed:
            err = max(err, hold_slate(f"{name} K{5 if window is None else 6}"
                                      f" vs plain, request {i}", rr, reqs[i],
                                      h.slate(), p.slate(), window,
                                      False)[1])
    rec = records[kernel]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
    print(f"  {kernel} vs plain at the router's shapes: every slate equal "
          f"or certified, d_hist max abs err {err:.3g}", flush=True)

    mean, parts, npump = pump_split(spans)
    ttfc = np.array([h.ttfc for h in handles if h.ttfc is not None])
    print(f"  host wall a pump: {mean:.1f} us over {npump} pumps ("
          + ", ".join(f"{p} {parts[p]:.1f}" for p in PUMP_SPANS)
          + " us); TTFC mean {:.3f} ms, p99 {:.3f} ms; fill ratio {:.3f}; "
          "peak concurrency {}; chunk N+1 still running when chunk N was "
          "delivered in {} of {} pumps ({:.2f})".format(
              ttfc.mean() * 1e3, np.percentile(ttfc, 99) * 1e3,
              st.fill_ratio, peak, sum(overlap), len(overlap),
              sum(overlap) / max(len(overlap), 1)), flush=True)
    dev = device_ms(lambda: main(), kernel, launches, reps=3)
    print(f"  {kernel} device time by torch.profiler: {ms_text(dev)} for "
          f"{launches} launches"
          + ("" if dev is None else f", {dev / launches:.4f} ms a launch"),
          flush=True)


def run_router_serve(records, model):
    """Phase 14 (c): ``launch.serve_router`` at DeepFM's published width
    on phase 10's model: 64 requests x 2000 candidates, shortlist 200,
    slate 10, 16 slots, chunk 4; every slate (the warm set's too) against
    the per-request ``rerank`` (K1)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve_router

    name = "phase 14(c) serve_router"
    cfg = get_arch("deepfm").config
    # router_run's observability session is the one the launcher's
    # rebuild count reads (its --metrics-out would install the same)
    args = serve_router.parser().parse_args([
        "--no-reduced", "--requests", "64", "--candidates", "2000",
        "--shortlist", "200", "--slate", "10", "--slots", "16", "--chunk",
        "4", "--qps", "1000", "--parity-sample", "64", "--use-kernel",
    ])
    print(f"[{name}] deepfm (published width), {args.requests} requests x "
          f"{args.candidates} candidates, shortlist {args.shortlist}, slate "
          f"{args.slate} (k in [{args.slate // 2}, {args.slate}]), "
          f"{args.slots} slots, chunk {args.chunk}, {args.qps:g} requests/s "
          f"offered", flush=True)
    dev = torch.device("cuda")
    (out, rr, pairs), counts, _, _, _, wall = router_run(
        lambda: serve_router.serve(model, cfg, args, dev))
    st = rr.router.stats
    check(counts.get("fused_chunk_exact") == st.chunks_launched
          and counts.get("fm_interaction") == 1,
          f"{name}: launches {counts}, router_chunks_launched_total "
          f"{st.chunks_launched}")
    check(out.get("rebuilds_after_warmup") == 0,
          f"{name}: rebuilds_after_warmup {out.get('rebuilds_after_warmup')}")
    check(out["completed"] == args.requests and out["timed_out"] == 0,
          f"{name}: {out}")
    check(len(pairs) == args.requests + args.slots,
          f"{name}: {len(pairs)} slates held")
    diverged = sum(hold_slate(f"{name} request {req.rid}", rr, req,
                              h.slate(), (ei, ed), None, True)[0]
                   for req, h, ei, ed in pairs)
    for kernel in ("fused_chunk_exact", "fm_interaction"):
        records.setdefault(kernel, {"launches": 0})["launches"] += \
            counts[kernel]
    print(f"  main path: {wall * 1e3:.1f} ms host wall (scoring, warm set, "
          f"open loop, parity reranks); launches {counts} (the "
          f"{counts.get('dpp_greedy_resident', 0)} K1 launches are the "
          f"parity reranks); {len(pairs) - diverged} of {len(pairs)} slates "
          f"equal the per-request rerank index for index, d_hist bit for "
          f"bit, the rest certified", flush=True)
    print("  serve_router " + json.dumps(out), flush=True)


def run_router(records, rng, model):
    """Phase 14: the router on the card: (a) exact, (b) windowed, (c)
    ``serve_router`` on DeepFM, (d) Figure 7 at its --smoke size."""
    from repro_torch.figures import fig7_serving

    catalog = torch.from_numpy(
        rng.standard_normal(size=(100_000, D), dtype=np.float32)).to("cuda")
    catalog /= catalog.norm(dim=1, keepdim=True)
    run_router_phase(records, rng, catalog, "a", None, 50, 25, 50, 8)
    run_router_phase(records, rng, catalog, "b", 10, 200, 100, 200, 16)
    del catalog
    run_router_serve(records, model)
    print("[phase 14(d) fig7] Figure 7 at its --smoke size, through its "
          "main and its gates", flush=True)
    _, counts = figure_run("fig7", lambda: fig7_serving.main(
        fast_mode=True, device="cuda"))
    check(set(counts) == {"fused_chunk_exact", "dpp_greedy_resident"},
          f"phase 14(d) fig7: launches {counts}")
    records["fused_chunk_exact"]["launches"] += counts["fused_chunk_exact"]
    print(f"  fig7: launches {counts} (K5 the router and the serial "
          f"streams, every slate held by the figure; K1 its reference "
          f"reranks)", flush=True)


# ---------------------------------------------------------------------------
# Phase 15: session-aware incremental rerank (K6) on the card
# ---------------------------------------------------------------------------

SESSION_VERBS = ("resume", "extend", "rescore", "rebuild", "evict")
K6 = "fused_chunk_windowed"
K2 = "dpp_greedy_resident_windowed"
SESSION_CAP, SESSION_CHUNK, SESSION_W = 2000, 8, 10


def session_run(fn):
    """One session main-path run ``fn()`` with the launch counters and a
    fresh observability session set right before and read right after:
    (fn's result, the launches, the metrics snapshot, the spans, host
    wall)."""
    from repro_torch import obs
    from repro_torch.kernels import cuda

    obs.disable()
    obs.enable(obs.ObsConfig(enabled=True))
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda.launch_counts()
    snap = obs.registry().snapshot()
    spans = obs.tracer().finished()
    obs.disable()
    return out, counts, snap, spans, wall


def plain_launchers(fn):
    """``fn()`` with every chunk launcher built in it (a session's,
    ``kernels.dpp_greedy.ops.chunk_launcher``) running its kernel's plain
    version on the same operands instead of the kernel."""
    from repro_torch.kernels.dpp_greedy import ops
    from repro_torch.kernels.dpp_greedy import tiled as tm

    def plain(V, C, d2, t, stopped, win, chunk, eps, tile_m, vres=False):
        if win is None:
            return lambda: tm.fused_chunk_exact_plain(V, C, d2, t, stopped,
                                                      chunk, eps)
        return lambda: tm.fused_chunk_windowed_plain(V, C, d2, t, stopped,
                                                     win, chunk, eps)

    real = ops.chunk_launcher
    ops.chunk_launcher = plain
    try:
        return fn()
    finally:
        ops.chunk_launcher = real


def session_gains64(sess, before, dead):
    """``gains(prefix)`` for :func:`certify_lane` over a session's host
    mirrors: the float64 windowed gains of every pool column given the
    history ``before`` a chunk plus ``prefix`` (pool columns), the
    columns ``dead`` before the chunk at -inf."""
    V64 = torch.as_tensor(sess._Vh, dtype=torch.float64, device="cuda")
    diag = (V64 * V64).sum(0)
    live = torch.as_tensor(~dead, device="cuda")

    def gains(prefix):
        pre = torch.as_tensor(list(before) + [int(x) for x in prefix],
                              dtype=torch.long, device="cuda")
        return _gains64(V64, diag, live, pre, sess.w)

    return gains


def hold_session_chunk(name, sess, n, eps):
    """One ``next_chunk(n)`` of ``sess`` held against the float64
    from-scratch conditional greedy over its host mirrors as they stood
    before it: the same pool columns, or parting at a certified float64
    near-tie; gains within rtol/atol where they agree.  Returns (the
    chunk's (ids, gains), diverged, max abs gain error)."""
    before, dead = list(sess._shown), sess._dead.copy()
    ids, got = sess.next_chunk(n)
    cols = sess._shown[len(before):]
    gains = session_gains64(sess, before, dead)
    eps2 = float(np.float32(eps) * np.float32(eps))
    want, wv = [], []
    for _ in range(n):
        g = gains(want)
        j = int(g.argmax())
        if not g[j].item() > eps2:
            break
        want.append(j)
        wv.append(float(np.sqrt(g[j].item())))
    a = np.array(cols + [-1] * (n - len(cols)))
    r = np.array(want + [-1] * (n - len(want)))
    p = len(cols)
    if not np.array_equal(a, r):
        where = certify_lane(name, gains, a, r, eps)
        p = where[0]
        print(f"  {name}: parts from the float64 greedy at step {p} ({where[1]}"
              f" vs {where[2]}; float64 gains {where[3]} / {where[4]}), a "
              f"certified near-tie", flush=True)
    err = float(np.abs(got[:p] - np.array(wv[:p])).max()) if p else 0.0
    check(np.allclose(got[:p], wv[:p], rtol=RTOL, atol=ATOL),
          f"{name}: gains beyond rtol {RTOL} / atol {ATOL} of the float64 "
          f"greedy ({err})")
    return (ids, got), p < len(cols), err


def verb_split(spans):
    """Mean host microseconds and count of each session verb's span, and
    of an extend's or a rescore's by how its delta ran on the card (its
    ``solve``: a graph's replay, the graph's capture on the width's first
    delta, or eager below a full ring)."""
    out = {}
    for v in SESSION_VERBS:
        mine = [s for s in spans if s["name"] == f"serving.session.{v}"]
        d = [s["dur_us"] for s in mine]
        out[v] = (statistics.fmean(d) if d else None, len(d))
        for how in sorted({s["attrs"].get("solve") for s in mine} - {None}):
            d = [s["dur_us"] for s in mine if s["attrs"]["solve"] == how]
            out[f"{v} {how}"] = (statistics.fmean(d), len(d))
    return out


def verb_text(split):
    return ", ".join(f"{v} {'-' if us is None else f'{us:.1f} us'} (x{n})"
                     for v, (us, n) in split.items())


def delta_payload(rng, dm):
    """``dm`` fresh candidates as a server receives them, on the host:
    uniform scores (dm,) and unit-norm Gaussian features (dm, D)."""
    f = rng.standard_normal(size=(dm, D), dtype=np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    return rng.uniform(size=dm).astype(np.float32), f


def rescore_payload(rng, sess, n):
    """``n`` global ids of ``sess`` (an eighth of them already shown, the
    rest live) and new uniform scores for them."""
    shown = sess.shown
    live = sess._gid[~sess._dead]
    k = max(1, n // 8)
    ids = np.concatenate([rng.choice(shown, size=k, replace=False),
                          rng.choice(live, size=n - k, replace=False)])
    return ids, rng.uniform(size=n).astype(np.float32)


def session_cfg(**kw):
    """Phase 15's rerank config: phase 1's setup (shortlist 1000,
    alpha 3, eps 1e-3) at w = 10 on the kernels; a session's slate is
    its first 4 chunks, so its K2 rerank is 32 long."""
    from repro_torch.serving import DPPRerankConfig

    base = dict(slate_size=4 * SESSION_CHUNK, shortlist=1000, alpha=ALPHA,
                eps=EPS, window=SESSION_W, use_kernel=True)
    base.update(kw)
    return DPPRerankConfig(**base)


def warm_sessions(reqs):
    """Every session verb once on a throwaway store (a 1-byte budget:
    each touch evicts and rebuilds), so the first calls of cuSOLVER's
    Cholesky, cuBLAS's triangular solve and the K6 module are out of the
    timed verbs."""
    from repro_torch.serving import Reranker, SessionConfig

    rng = np.random.default_rng(SEED + 15)
    rr = Reranker(session_cfg(), session_config=SessionConfig(
        capacity=SESSION_CAP, budget_bytes=1), device="cuda")
    a, b = rr.session(reqs[0]), rr.session(reqs[1])
    for s in (a, b, a):
        s.next_chunk(SESSION_CHUNK)
    b.extend(*delta_payload(rng, 128))
    a.rescore(*rescore_payload(rng, a, 64))
    b.next_chunk(SESSION_CHUNK)
    torch.cuda.synchronize()


def run_session_resume(records, reqs, smi):
    """Phase 15(a): 32 sessions scroll 4 chunks each, round robin, no
    delta; each session's 32 items against its request's K2 rerank index
    for index and d_hist bit for bit; K6 against its plain version."""
    from repro_torch.serving import Reranker, SessionConfig

    name = "phase 15(a) session resume"
    n = len(reqs)
    rr = Reranker(session_cfg(), session_config=SessionConfig(
        capacity=SESSION_CAP), device="cuda")
    want = [tuple(x.cpu().numpy() for x in rr.rerank(r)) for r in reqs]
    line = chunk_tiles(SESSION_CAP, SESSION_W, True, 1, torch.device(
        "cuda"))[0]
    print(f"[{name}] {n} sessions (pool 100,000, shortlist 1000, capacity "
          f"{SESSION_CAP}, w = {SESSION_W}), 4 chunks of {SESSION_CHUNK} "
          f"each, round robin; K6 a chunk: {line}; on {smi}", flush=True)

    def main(rr):
        sess = [rr.session(r) for r in reqs]
        out = [[] for _ in reqs]
        for _ in range(4):
            for i, s in enumerate(sess):
                out[i].append(s.next_chunk(SESSION_CHUNK))
        return sess, [tuple(np.concatenate(x) for x in zip(*o))
                      for o in out]

    (sess, out), counts, _, spans, wall = session_run(lambda: main(rr))
    count_chunks(records, name, counts, K6, 4 * n)
    for i, ((gi, gd), (ei, ed)) in enumerate(zip(out, want)):
        check(np.array_equal(gi, ei.astype(np.int64)),
              f"{name}: session {i} differs from its K2 rerank: {gi} vs {ei}")
        err = float(np.abs(gd - ed).max())
        check(err == 0.0, f"{name}: session {i} d_hist differs from K2's "
                          f"by {err}")
    nbytes = sess[0]._resident_bytes
    print(f"  main path: {wall * 1e3:.1f} ms host wall, launches {counts} "
          f"(one a chunk); all {n} sessions' {4 * SESSION_CHUNK} items equal "
          f"their K2 rerank index for index, d_hist bit for bit; "
          f"{nbytes} B of device state a session; verbs: "
          f"{verb_text(verb_split(spans))}", flush=True)

    # the same sessions on K6's plain version
    _, plain = plain_launchers(lambda: main(Reranker(
        session_cfg(), session_config=SessionConfig(
            capacity=SESSION_CAP), device="cuda")))
    torch.cuda.synchronize()
    err = 0.0
    for i, ((gi, gd), (pi, pd)) in enumerate(zip(out, plain)):
        check(np.array_equal(gi, pi), f"{name}: session {i} on K6 differs "
                                      f"from the plain version")
        check(np.allclose(gd, pd, rtol=RTOL, atol=ATOL),
              f"{name}: session {i} gains beyond rtol/atol of the plain "
              f"version")
        err = max(err, float(np.abs(gd - pd).max()))
    rec = records[K6]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
    print(f"  {K6} vs plain at the sessions' shape: every chunk equal, "
          f"gains max abs err {err:.3g}", flush=True)

    probe = rr.session(reqs[0], sid="probe")
    dev = device_ms(lambda: probe.next_chunk(SESSION_CHUNK), K6, 1)
    rr.sessions.close("probe")
    print(f"  {K6} device time by torch.profiler, one session launch "
          f"({SESSION_CHUNK} steps, M = {SESSION_CAP}): {ms_text(dev)}; on "
          f"{smi}", flush=True)
    return rr, sess, want


def run_session_deltas(records, rr, sess, rng, catalog, smi):
    """Phase 15(b): extend (128 fresh candidates) and rescore (64 ids)
    interleaved with scrolls on (a)'s sessions, every chunk after a delta
    held against the float64 conditional greedy; an eps-stopped rank-2
    session revived by an extend."""
    from repro_torch.serving import Reranker, RerankRequest, SessionConfig

    name = "phase 15(b) session deltas"
    n = len(sess)
    print(f"[{name}] on (a)'s {n} sessions: extend(128), scroll, rescore(64"
          f"), scroll, extend(128), scroll; every post-delta chunk against "
          f"the float64 conditional greedy over the host mirrors; a rank-2 "
          f"session (eps 0.05) stops, answers empty, an extend revives it; "
          f"on {smi}", flush=True)
    ext = [[delta_payload(rng, 128) for _ in sess] for _ in range(2)]
    # a pool in a 2-D subspace of the catalog's features: the third
    # conditioned gain is float32 noise, under eps = 0.05 by far
    basis = torch.linalg.qr(torch.randn(D, 2, generator=torch.Generator(
        "cuda").manual_seed(SEED), device="cuda"))[0]
    f2 = catalog[:5000] @ basis @ basis.T
    f2 = f2 / f2.norm(dim=1, keepdim=True)
    rank2 = RerankRequest(scores=torch.from_numpy(rng.uniform(
        size=5000).astype(np.float32)).to("cuda"), feats=f2)
    rr2 = Reranker(session_cfg(eps=0.05), session_config=SessionConfig(
        capacity=SESSION_CAP), device="cuda")
    revive = delta_payload(rng, 128)
    held = {"diverged": 0, "err": 0.0, "chunks": 0}

    def hold(label, s, eps=EPS):
        (ids, _), div, err = hold_session_chunk(f"{name} {label}", s,
                                                SESSION_CHUNK, eps)
        held["diverged"] += div
        held["err"] = max(held["err"], err)
        held["chunks"] += 1
        return len(ids)

    def main():
        for i, s in enumerate(sess):
            s.extend(*ext[0][i])
            hold(f"session {i} after extend", s)
            s.rescore(*rescore_payload(rng, s, 64))
            hold(f"session {i} after rescore", s)
            s.extend(*ext[1][i])
            hold(f"session {i} after a second extend", s)
        s2 = rr2.session(rank2)
        first = hold("rank-2 session", s2, eps=0.05)
        stopped = hold("rank-2 session, stopped", s2, eps=0.05)
        s2.extend(*revive)
        hold("rank-2 session revived", s2, eps=0.05)
        return first, stopped

    (first, stopped), counts, snap, spans, wall = session_run(main)
    check(first < SESSION_CHUNK and stopped == 0,
          f"{name}: the rank-2 session gave {first} then {stopped} items, "
          f"expected an eps-stop then nothing")
    expect = 3 * n + 2  # the stopped session's empty chunk launches nothing
    count_chunks(records, name, counts, K6, expect)
    deltas = snap["counters"].get("session_deltas_total", {})
    check(deltas == {"op=extend": 2 * n + 1, "op=rescore": n},
          f"{name}: session_deltas_total {deltas}")
    print(f"  main path: {wall * 1e3:.1f} ms host wall (the float64 "
          f"references included), launches {counts}; {held['chunks']} "
          f"chunks equal the float64 conditional greedy, "
          f"{held['diverged']} parting at a certified near-tie, gains max "
          f"abs err {held['err']:.3g}; the rank-2 session stopped after "
          f"{first} items, gave {stopped} with no launch, and the extend "
          f"revived it; session_deltas_total {deltas}; verbs: "
          f"{verb_text(verb_split(spans))}; on {smi}", flush=True)


def run_session_evict(records, reqs, want, rng, smi):
    """Phase 15(c): the 32 requests under an 8 MiB budget (about 9
    resident): 3 round-robin scrolls, an extend round, a rescore round,
    each chunk against a control store that never evicts; the control's
    own chunks against (a)'s K2 reranks ``want`` (the scrolls) and the
    float64 conditional greedy (after the deltas)."""
    from repro_torch.serving import Reranker, SessionConfig

    name = "phase 15(c) session eviction"
    budget = 8 << 20
    n = len(reqs)
    print(f"[{name}] {n} sessions under budget_bytes = {budget}, against "
          f"the same {n} in a store that never evicts: 3 scrolls round "
          f"robin, extend(128) + scroll, rescore(64) + scroll; on {smi}",
          flush=True)
    ext = [delta_payload(rng, 128) for _ in reqs]

    def main():
        rr = Reranker(session_cfg(), session_config=SessionConfig(
            capacity=SESSION_CAP, budget_bytes=budget), device="cuda")
        ctl_rr = Reranker(session_cfg(), session_config=SessionConfig(
            capacity=SESSION_CAP), device="cuda")
        ev = [rr.session(r) for r in reqs]
        ctl = [ctl_rr.session(r) for r in reqs]
        one = max(s._resident_bytes for s in ev)
        err, peak, rebuilt, diverged = 0.0, 0, 0, 0
        c = SESSION_CHUNK
        for step in range(5):
            for i in range(n):
                if step == 3:
                    ctl[i].extend(*ext[i])
                    ev[i].extend(*ext[i])
                elif step == 4:
                    payload = rescore_payload(rng, ctl[i], 64)
                    ctl[i].rescore(*payload)
                    ev[i].rescore(*payload)
                rebuilt += not ev[i].resident
                if step < 3:
                    ic, dc = ctl[i].next_chunk(c)
                    wi, wd = want[i]
                    check(np.array_equal(ic, wi[step * c:(step + 1) * c])
                          and np.array_equal(dc, wd[step * c:(step + 1) * c]),
                          f"{name}: control session {i} step {step} differs "
                          f"from its K2 rerank")
                else:
                    (ic, dc), div, _ = hold_session_chunk(
                        f"{name} control session {i} step {step}", ctl[i],
                        c, EPS)
                    diverged += div
                ie, de = ev[i].next_chunk(c)
                check(np.array_equal(ie, ic),
                      f"{name}: step {step} session {i}: {ie} vs the "
                      f"never-evicted control's {ic}")
                e = float(np.abs(de - dc).max())
                check(e <= 1e-5, f"{name}: step {step} session {i}: gains "
                                 f"{e} from the control's")
                err = max(err, e)
                held = rr.sessions.resident_bytes()
                peak = max(peak, held)
                check(held <= budget + one,
                      f"{name}: {held} resident bytes over the budget plus "
                      f"one session")
        return rr, err, peak, rebuilt, one, diverged

    (rr, err, peak, rebuilt, one, diverged), counts, snap, spans, wall = \
        session_run(main)
    count_chunks(records, name, counts, K6, 2 * 5 * n)
    ev_total = sum(snap["counters"].get("session_evictions_total",
                                        {}).values())
    check(ev_total > 0 and rebuilt > 0,
          f"{name}: {ev_total} evictions, {rebuilt} touches of an evicted "
          f"session")
    resident = rr.sessions._resident_count()
    print(f"  main path: {wall * 1e3:.1f} ms host wall, launches {counts} "
          f"(both stores); the control's scrolls equal (a)'s K2 reranks bit "
          f"for bit, its post-delta chunks the float64 conditional greedy "
          f"({diverged} parting at a certified near-tie); {rebuilt} touches "
          f"of an evicted session, every chunk equal to the control's index "
          f"for index, gains max abs diff {err:.3g}; resident at the end "
          f"{resident} sessions, "
          f"{rr.sessions.resident_bytes()} B, peak {peak} B (budget "
          f"{budget} + one session {one}); session_evictions_total "
          f"{ev_total:g}, session_deltas_total "
          f"{snap['counters'].get('session_deltas_total')}, "
          f"session_resident_bytes "
          f"{snap['gauges'].get('session_resident_bytes')}, "
          f"session_resident_count "
          f"{snap['gauges'].get('session_resident_count')}", flush=True)
    split = verb_split(spans)
    print(f"  host wall a verb (spans, warm): {verb_text(split)}; on {smi}",
          flush=True)


def run_sessions(records, rng):
    """Phase 15: sessions on the card: (a) resume, (b) deltas, (c)
    eviction, (d) Figure 10 at its --smoke size, (e) serve_recsys's
    session demo."""
    from repro_torch.examples import serve_recsys
    from repro_torch.figures import fig10_session
    from repro_torch.figures.common import device_name
    from repro_torch.serving import RerankRequest

    smi = device_name(torch.device("cuda", 0))
    t0 = time.perf_counter()
    catalog = torch.from_numpy(
        rng.standard_normal(size=(100_000, D), dtype=np.float32)).to("cuda")
    catalog /= catalog.norm(dim=1, keepdim=True)
    reqs = [RerankRequest(scores=torch.from_numpy(rng.uniform(
        size=100_000).astype(np.float32)).to("cuda"), feats=catalog)
        for _ in range(32)]
    warm_sessions(reqs)
    rr, sess, want = run_session_resume(records, reqs, smi)
    run_session_deltas(records, rr, sess, rng, catalog, smi)
    del rr, sess
    run_session_evict(records, reqs, want, rng, smi)
    del reqs, catalog

    print("[phase 15(d) fig10] Figure 10 at its --smoke size, through its "
          "main and its gates (parity, and the delta event faster than the "
          "full re-rerank)", flush=True)
    _, counts = figure_run("fig10", lambda: fig10_session.main(
        fast_mode=True, device="cuda"))
    check(counts == {K6: 9, K2: 3},
          f"phase 15(d) fig10: launches {counts}")
    for kernel, c in counts.items():
        records.setdefault(kernel, {"launches": 0})["launches"] += c
    print(f"  fig10: launches {counts} (K6 the kernel row's 6 scrolls and 3 "
          f"delta events, K2 its warm and 2 timed full re-reranks; the "
          f"figure holds every chunk and every re-rerank slate against "
          f"float64); on {smi}", flush=True)

    print("[phase 15(e) session_demo] examples/serve_recsys.py's "
          "session_demo on the card, against the same demo on the CPU "
          "(K6's plain version)", flush=True)
    got, counts = figure_run("session_demo",
                             lambda: serve_recsys.session_demo("cuda"))
    count_chunks(records, "phase 15(e)", counts, K6, 3)
    want = serve_recsys.session_demo("cpu")
    check(all(np.array_equal(g, w) for g, w in zip(got, want)),
          f"phase 15(e): the card's scrolls {got} differ from the CPU's "
          f"{want}")
    print(f"  session_demo: launches {counts}, its 3 scrolls equal the "
          f"CPU's index for index; phase 15 took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 16: the candidate-sharded rerank (torch.distributed ranks)
# ---------------------------------------------------------------------------

SHARDED_B_USERS = 8  # phase 16(b): phase 1's first users
SHARDED_A_BACKEND = "nccl"  # phase 16(a): one NCCL rank on the card
SHARDED_TIMEOUT_S = 300


def save_request(path, scores, feats, mask):
    """Write a request's arrays for ``launch.serve_sharded --inputs``."""
    arrays = {"scores": scores.cpu().numpy(), "feats": feats.cpu().numpy()}
    if mask is not None:
        arrays["mask"] = mask.cpu().numpy()
    np.savez(path, **arrays)
    return path


def start_child(name, npz, P, backend, shortlist, stream=0, extra=()):
    """Start ``python -m repro_torch.launch.serve_sharded`` with P ranks
    on ``npz``'s request, exact k = 50 and windowed w = 10, k = 200
    (``stream``: also streamed in chunks of that many; ``extra``: more
    arguments), as a child process; :func:`finish_child` collects it."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_sharded",
           "--devices", str(P), "--backend", backend, "--device", "cuda",
           "--inputs", str(npz), "--window", "0", "10", "--slate", "50",
           "200", "--shortlist", str(shortlist), "--alpha", str(ALPHA),
           "--eps", str(EPS), "--timeout", str(SHARDED_TIMEOUT_S),
           "--stream", str(stream), *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT, stdin=subprocess.DEVNULL)
    return name, P, backend, proc, time.perf_counter()


def finish_child(child):
    """Wait for a :func:`start_child` process under its time limit and
    return its JSON record.  A child that fails or passes its limit
    fails the phase with its stderr tail (it is killed first)."""
    name, P, backend, proc, t0 = child
    try:
        out, err = proc.communicate(timeout=SHARDED_TIMEOUT_S + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        print(f"[{name}] serve_sharded passed its time limit; stderr "
              f"tail:\n{err[-3000:]}", file=sys.stderr, flush=True)
        raise SmokeFailure(f"{name}: serve_sharded timed out") from None
    if proc.returncode != 0 or not out.strip():
        print(f"[{name}] serve_sharded exited with {proc.returncode}; "
              f"stderr tail:\n{err[-3000:]}", file=sys.stderr, flush=True)
        raise SmokeFailure(f"{name}: serve_sharded failed")
    print(f"  {name}: {P} rank(s) under {backend}, the child process took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return json.loads(out.strip().splitlines()[-1])


def hold_sharded(name, got, want, ref, window):
    """A sharded slate ``got`` ((ids, d_hist) lists, global ids) against
    the single-device rerank's ``want`` (card tensors) on the same users:
    each lane equal, or parting at a float64-certified near-tie
    (``certify`` on the single-device shortlist ``ref``); d_hist over the
    agreeing prefix within rtol/atol.  Returns (diverging lanes, max abs
    d_hist difference)."""
    gi = torch.tensor(got[0], dtype=torch.int64)
    gd = torch.tensor(got[1], dtype=torch.float32)
    wi, wd = want[0].cpu().to(torch.int64), want[1].cpu()
    check(gi.shape == wi.shape, f"{name}: slate shape {tuple(gi.shape)} vs "
                                f"{tuple(wi.shape)}")
    lanes, err = [], 0.0
    for b in range(gi.shape[0]):
        same = torch.equal(gi[b], wi[b])
        p = gi.shape[1] if same else int(torch.nonzero(gi[b] != wi[b])[0])
        if not same:
            top = ref["top_i"][b]
            m = None if ref["m_top"] is None else ref["m_top"][b:b + 1]
            certify(f"{name}: lane {b}", ref["V"][b:b + 1], m,
                    to_local(top, gi[b].numpy()),
                    to_local(top, wi[b].numpy()), window, EPS)
            lanes.append(b)
        if p:
            e = (gd[b, :p] - wd[b, :p]).abs().max().item()
            err = max(err, e)
            check(torch.allclose(gd[b, :p], wd[b, :p], rtol=RTOL, atol=ATOL),
                  f"{name}: lane {b} d_hist beyond rtol {RTOL} / atol {ATOL} "
                  f"({e})")
    bits = ", ids and d_hist bit for bit" if (
        not lanes and torch.equal(gd, wd)) else ""
    print(f"  {name}: {len(lanes)} of {gi.shape[0]} lanes part (each at a "
          f"certified float64 near-tie); d_hist max abs diff {err:.3g}{bits}",
          flush=True)
    return lanes, err


def sharded_runs(name, rec, records):
    """Check one serve_sharded record's runs: every rank launched k update
    entries in its main-path call and nothing else; print each rank's
    host wall and its collectives' share; add the launches to the
    kernels' record."""
    for run, k in zip(rec["runs"], (50, 200)):
        kernel = ("tiled_update_exact" if run["window"] is None
                  else "tiled_update_windowed")
        check(run["ranks_agree"] and len(run["ranks"]) == rec["devices"],
              f"{name}: the ranks' slates disagree")
        parts = []
        for r in run["ranks"]:
            check(r["launches"] == {kernel: k},
                  f"{name}: rank {r['rank']} launched {r['launches']}, "
                  f"expected {{{kernel!r}: {k}}} (one update a step, no "
                  f"K3/K4)")
            records.setdefault(kernel, {"launches": 0})["launches"] += k
            parts.append(
                f"rank {r['rank']} {r['steady_call_s'] * 1e3:.1f} ms, "
                f"collectives {r['collective_s'] * 1e3:.1f} of "
                f"{r['timed_call_s'] * 1e3:.1f} ms "
                f"({r['collective_s'] / r['timed_call_s']:.1%}, "
                f"{r['collectives']} collectives)")
        print(f"  {name}, window {run['window']}, k={k}: host wall by rank "
              f"(the steady call; collectives timed in a third call that "
              f"synchronises around each): " + "; ".join(parts)
              + f"; {kernel} x {k} a rank", flush=True)


@contextlib.contextmanager
def patched_updates(tm, plain=False, wrap=None):
    """Within the block, the sharded loop's update step runs the plain
    update entry (``plain``) instead of the kernel's launch, and is
    wrapped as ``wrap(step)`` when given."""
    real = tm.update_launcher

    def launcher(operands, base, keys, tile):
        if not plain:
            step = real(operands, base, keys, tile)
        else:
            fn = (tm.tiled_update_windowed_plain if len(operands) == 12
                  else tm.tiled_update_exact_plain)

            def step():
                fn(*operands, base, keys, tile)
        return step if wrap is None else wrap(step)

    tm.update_launcher = launcher
    try:
        yield
    finally:
        tm.update_launcher = real


@contextlib.contextmanager
def one_rank_group(work):
    """A one-rank gloo group in this process and its mesh on the card
    (phases 16(c) and 17(a)); destroyed on the way out."""
    import torch.distributed as dist

    from repro_torch.distributed import init_group, make_mesh

    init_group("gloo", 0, 1, work / "rendezvous16c", timeout_s=300)
    try:
        yield make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def run_update_entries(records, ref, mesh):
    """16(c): each update entry against its plain version, a whole slate
    on phase 3's shortlist (B = 4, D = 100, C = 65,536) as the shard of
    global ids from ``base = 3 C`` on, through ``core.sharded.greedy_local``
    on the one-rank gloo group ``mesh``; timed as K3/K4 are (one CUDA
    event pair a launch, summed; device time by torch.profiler).  Keeps
    each slate (shard-local ids) and its device time in ``ref["c16"]``
    for phase 17(a)."""
    from repro_torch.core.sharded import greedy_local
    from repro_torch.kernels import cuda
    from repro_torch.kernels.dpp_greedy import tiled as tm

    V, m_top = ref["V"], ref["m_top"]
    B, _, C = V.shape
    base = 3 * C
    ref["c16"] = {}
    for kernel, k, w in (("tiled_update_exact", 50, None),
                         ("tiled_update_windowed", 200, 10)):
        name = f"phase 16(c) {kernel}"
        print(f"[{name}] phase 3's shortlist B={B} C={C} k={k} "
              f"window={w}, base {base}", flush=True)

        def run(plain=False, wrap=None):
            with patched_updates(tm, plain, wrap):
                sel, dh = greedy_local(V, m_top, k, mesh=mesh, base=base,
                                       window=w, eps=EPS)
            return torch.where(sel >= 0, sel - base, -1), dh

        cuda.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        check(cuda.launch_counts() == {kernel: k},
              f"{name}: launches {cuda.launch_counts()}")
        want = run(plain=True)
        torch.cuda.synchronize()
        _, err = compare(name, V, m_top, got, want, w, EPS)
        direct = ref["direct"][w]
        lanes = certify(f"{name} vs phase {3 if w is None else 4}", V,
                        m_top, got[0], direct[0], w, EPS)
        print(f"  {name}: against phase {3 if w is None else 4}'s direct "
              f"{'K3' if w is None else 'K4'} slate {len(lanes)} of {B} "
              f"lanes part (certified); d_hist max abs diff "
              f"{(got[1] - direct[1]).abs().max().item():.3g}",
              flush=True)

        def summed(plain):
            def one():
                acc = []
                run(plain, lambda step: lambda *a: acc.append(
                    event_ms(lambda: step(*a))))
                return sum(acc)
            return one

        reps = TIMING_REPS // 4  # a call stages each step through host
        ms = time_events(summed(False), reps)
        plain_ms = time_events(summed(True), PLAIN_REPS)
        dev = device_ms(run, kernel, k, reps=1)
        records.setdefault(kernel, {"launches": 0})["calls_launches"] = k
        kernel_record(records, kernel, ms, plain_ms,
                      bound(B, D, C, k, w, (got[0] >= 0).sum(1)), err,
                      f"sum of {k} launches, CUDA events per launch",
                      device=dev, reps=reps)
        stream_floor(B, C, k, dev, exact=w is None)
        ref["c16"][w] = (got, dev)


def run_sharded(records, refs, mesh):
    """Phase 16: the candidate-sharded rerank, ``Reranker(DPPRerankConfig(
    mesh=...)).rerank`` in ranks started by ``launch.serve_sharded``;
    16(c) on the one-rank group ``mesh`` in this process."""
    t0 = time.perf_counter()
    run_update_entries(records, refs["a"], mesh)
    print(f"  phase 16(c) took {time.perf_counter() - t0:.1f} s", flush=True)
    a = refs["a"]
    name = f"phase 16(a) one rank, {SHARDED_A_BACKEND}"
    print(f"[{name}] phase 3's request: B=4 pool 1,000,000 shortlist "
          f"65,536 D=100, a 10% seen mask; exact k=50, windowed w=10 "
          f"k=200", flush=True)
    rec = finish_child(start_child(name, a["npz"], 1, SHARDED_A_BACKEND,
                                   65536))
    sharded_runs(name, rec, records)
    for run in rec["runs"]:
        w = run["window"]
        hold_sharded(f"{name} window {w} vs phase {3 if w is None else 4} "
                     f"({'K3' if w is None else 'K4'})",
                     (run["indices"], run["d_hist"]), a["out"][w], a, w)
    print(f"  phase 16(c) and (a) took {time.perf_counter() - t0:.1f} s",
          flush=True)
    b = refs["b"]
    print(f"[phase 16(b)] phase 1's first {SHARDED_B_USERS} users: pool "
          f"100,000 shortlist 1000 D=100; exact k=50, windowed w=10 k=200; "
          f"1 rank under {SHARDED_A_BACKEND}, 2 and 4 under gloo, the three "
          f"runs at once on the one card", flush=True)
    children = [start_child(f"phase 16(b) {P} rank(s), {backend}", b["npz"],
                            P, backend, 1000)
                for P, backend in ((1, SHARDED_A_BACKEND), (2, "gloo"),
                                   (4, "gloo"))]
    first = None
    for child in children:
        name = child[0]
        rec = finish_child(child)
        sharded_runs(name, rec, records)
        if first is None:
            first = rec
            for run in rec["runs"]:
                w = run["window"]
                hold_sharded(f"{name} window {w} vs phase "
                             f"{1 if w is None else 2} "
                             f"({'K1' if w is None else 'K2'})",
                             (run["indices"], run["d_hist"]), b["out"][w],
                             b, w)
            continue
        for run, run1 in zip(rec["runs"], first["runs"]):
            check(run["indices"] == run1["indices"],
                  f"{name}: window {run['window']}: the slate differs from "
                  f"the one-rank run's")
            got, want = (torch.tensor(r["d_hist"]) for r in (run, run1))
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  f"{name}: window {run['window']}: d_hist {err} from the "
                  f"one-rank run's")
            print(f"  {name}, window {run['window']}: every rank's slate "
                  f"equals the one-rank run's index for index; d_hist max "
                  f"abs diff {err:.3g}", flush=True)
    print(f"  phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 17: the sharded stream and figure 5
# ---------------------------------------------------------------------------

STREAM_CHUNK_A, STREAM_CHUNK_B = 16, 8  # phase 17(a), (b)


def run_stream_chunks(records, ref, mesh):
    """17(a): ``greedy_map_chunks`` on the one-rank gloo group ``mesh``,
    chunk 16, over 16(c)'s shard (phase 3's shortlist: B = 4, C = 65,536;
    exact k = 50, w = 10 k = 200).  One rank's shard starts at global id
    0 where 16(c)'s started at 3 C: the ids are compared shard-local, as
    16(c) kept them.  The concatenated chunks must equal 16(c)'s whole
    slate bit for bit, d_hist included; a call is k update launches
    through one launcher; the chunks' update-entry device time is printed
    beside 16(c)'s."""
    from repro_torch.core import GreedySpec, greedy_map_chunks
    from repro_torch.kernels import cuda
    from repro_torch.kernels.dpp_greedy import tiled as tm

    V, m_top = ref["V"], ref["m_top"]
    B, _, C = V.shape
    for kernel, k, w in (("tiled_update_exact", 50, None),
                         ("tiled_update_windowed", 200, 10)):
        name = f"phase 17(a) {kernel}"
        spec = GreedySpec(k=k, window=w, mesh=mesh, eps=EPS,
                          chunk_size=STREAM_CHUNK_A)
        print(f"[{name}] greedy_map_chunks on a one-rank mesh over phase "
              f"3's shortlist B={B} C={C} k={k} window={w}, chunk "
              f"{STREAM_CHUNK_A}", flush=True)

        def run(built=None):
            wrap = None if built is None else (
                lambda step: built.append(1) or step)
            with patched_updates(tm, wrap=wrap):
                chunks = list(greedy_map_chunks(spec, V=V, mask=m_top))
            return (torch.cat([c.indices for c in chunks], 1),
                    torch.cat([c.d_hist for c in chunks], 1), len(chunks))

        built = []
        cuda.reset_launch_counts()
        sel, dh, n = run(built)
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        check(counts == {kernel: k} and built == [1],
              f"{name}: launches {counts}, launchers built {len(built)} "
              f"(expected {{{kernel!r}: {k}}} through one launcher)")
        records[kernel]["launches"] += k
        whole, dev16 = ref["c16"][w]
        check(torch.equal(sel, whole[0]) and torch.equal(dh, whole[1]),
              f"{name}: the concatenated chunks differ from 16(c)'s whole "
              f"sharded slate")
        dev = device_ms(lambda: run(), kernel, k, reps=1)
        print(f"  {name}: {n} chunks equal 16(c)'s whole slate bit for "
              f"bit, d_hist included; {k} launches through one launcher; "
              f"update-entry device time {ms_text(dev)} for the stream "
              f"against {ms_text(dev16)} for 16(c)'s whole slate",
              flush=True)


def stream_runs(name, rec, records, ref):
    """Check one ``serve_sharded --stream`` record: every rank streamed
    k update launches a call and its chunks equalled its whole slate
    (the child raises otherwise); hold each window's slate against
    phase 1/2's K1/K2 slate of the user; print the stream's times and
    add its launches to the kernels' record."""
    sharded_runs(name, rec, records)
    for run, k in zip(rec["runs"], (50, 200)):
        w = run["window"]
        kernel = ("tiled_update_exact" if w is None
                  else "tiled_update_windowed")
        st = run["stream"]
        check(st["chunk_size"] == STREAM_CHUNK_B
              and len(st["ranks"]) == rec["devices"],
              f"{name}: window {w}: stream record {st}")
        for r in st["ranks"]:
            check(r["launches"] == {kernel: k},
                  f"{name}: rank {r['rank']}'s stream launched "
                  f"{r['launches']}, expected {{{kernel!r}: {k}}}")
            records[kernel]["launches"] += k
        hold_sharded(f"{name} window {w} vs phase {1 if w is None else 2} "
                     f"({'K1' if w is None else 'K2'})",
                     (run["indices"], run["d_hist"]), ref["out"][w], ref, w)
        coll = "; ".join(
            f"rank {r['rank']} collectives {r['collective_s'] * 1e3:.1f} of "
            f"{r['timed_stream_s'] * 1e3:.1f} ms ({r['collectives']})"
            for r in st["ranks"])
        print(f"  {name}, window {w}, k={k}, chunk {st['chunk_size']}: "
              f"first_chunk_s {st['first_chunk_s']:.6f}, stream_total_s "
              f"{st['stream_total_s']:.6f}, first chunk "
              f"{st['first_chunk_vs_whole']:.3f}x the whole slate's steady "
              f"call; every rank's chunks equal "
              f"its whole slate bit for bit; {coll} (a third stream "
              f"synchronised around each collective)", flush=True)


def run_sharded_stream(records, refs, mesh):
    """Phase 17: the sharded stream and figure 5.  (a) in this process on
    16(c)'s one-rank group; (b) ``launch.serve_sharded --stream 8`` on
    phase 1's user 0 as one NCCL rank and as 2 gloo ranks sharing the
    card, and (c) figure 5 ``--smoke`` (P = 1 NCCL, P = 2 gloo), the
    children of (b) and (c) started at once."""
    from repro_torch.figures import fig5_sharded

    t0 = time.perf_counter()
    run_stream_chunks(records, refs["a"], mesh)
    print(f"  phase 17(a) took {time.perf_counter() - t0:.1f} s", flush=True)
    b = refs["b"]
    one = {"V": b["V"][:1], "m_top": None, "top_i": b["top_i"][:1],
           "out": {w: (o[0][:1], o[1][:1]) for w, o in b["out"].items()}}
    print(f"[phase 17(b)] serve_sharded --stream {STREAM_CHUNK_B} on phase "
          f"1's user 0: pool 100,000 shortlist 1000 D=100; exact k=50, "
          f"windowed w=10 k=200; 1 rank under {SHARDED_A_BACKEND} and 2 "
          f"under gloo sharing the card, at once with (c)'s ranks",
          flush=True)
    children = [start_child(f"phase 17(b) {P} rank(s), {backend}",
                            b["npz1"], P, backend, 1000,
                            stream=STREAM_CHUNK_B)
                for P, backend in ((1, SHARDED_A_BACKEND), (2, "gloo"))]
    print("[phase 17(c) fig5] Figure 5 at its --smoke size through its "
          "main: P = 1 and 2 started at once", flush=True)
    fig, _ = figure_run("phase 17(c) fig5", lambda: fig5_sharded.main(
        fast_mode=True, device="cuda", at_once=True))
    # a rank's calls a mode: 2 tiles x 2 batch sizes x (a warm call and
    # the trials), k steps each
    cfg = fig5_sharded.PRESETS[True]
    per_rank = (2 * len({1, cfg["batch"]}) * (1 + cfg["trials"])
                * cfg["slate"])
    for P, counts in fig["launches"].items():
        want = {"tiled_update_exact": per_rank * P,
                "tiled_update_windowed": per_rank * P}
        check(counts == want, f"phase 17(c) fig5: P={P} launched {counts}, "
                              f"expected {want}")
        for kernel, n in counts.items():
            records[kernel]["launches"] += n
    print(f"  phase 17(c) fig5: {len(fig['rows'])} rows; update launches "
          f"{fig['launches']}", flush=True)
    recs = [finish_child(child) for child in children]
    for child, rec in zip(children, recs):
        stream_runs(child[0], rec, records, one)
    for run, run1 in zip(recs[1]["runs"], recs[0]["runs"]):
        check((run["indices"], run["d_hist"])
              == (run1["indices"], run1["d_hist"]),
              f"phase 17(b): window {run['window']}: 2 gloo ranks' slate "
              f"differs from the NCCL rank's")
    print(f"  phase 17(b): 2 gloo ranks' slates equal the NCCL rank's bit "
          f"for bit, d_hist included; phase 17 took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 18: the continuous-batching router on the candidate-sharded mesh
# ---------------------------------------------------------------------------

# 18(a): 96 requests exact, 32 windowed (each windowed per-request sharded
# reference costs about 0.7 s of host-bound steps on the card)
MESH_ROUTER = dict(n=96, n_windowed=32, slots=32, bucket=100_000, burst=32,
                   per_pump=8, lapsed=2)
MESH_ROUTER_B = dict(n=24, slots=8, chunk=8, lapsed=(5, 17), midflight=0,
                     midflight_s=0.05)


def same_slate(got, want):
    """Two (ids, d_hist) numpy pairs equal bit for bit."""
    return (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1]))


def mesh_router_run(mesh, reqs, window, cap, chunk, plain=False):
    """The router on ``mesh``: ``reqs`` through ``Reranker.submit``, the
    first ``burst`` at once, then ``per_pump`` before each pump, with the
    launch counters, telemetry and spans of :func:`router_run`."""
    from repro_torch.kernels.dpp_greedy import tiled as tm
    from repro_torch.serving import DPPRerankConfig, Reranker, RouterConfig

    c = MESH_ROUTER
    cfg = DPPRerankConfig(slate_size=cap, shortlist=1000, alpha=ALPHA,
                          eps=EPS, window=window, mesh=mesh)
    rcfg = RouterConfig(slots=c["slots"], chunk_size=chunk,
                        max_queue=len(reqs), max_candidates=c["bucket"])

    def main():
        rr = Reranker(cfg, router_config=rcfg, device="cuda")
        with patched_updates(tm, plain=plain):
            return rr, drive_router(rr, reqs, c["burst"], c["per_pump"])

    return router_run(main)


def run_router_mesh_a(records, mesh, catalog, rng, window, cap, k_lo, k_hi,
                      chunk):
    """18(a), exact or windowed: phase 14(a)'s draw through the router on
    the one-rank gloo group ``mesh`` (32 slots, a bucket of the whole
    100,000-item catalog): update launches, host wall a pump by span,
    TTFC and the entries' device time a pump, measured here.  Returns
    ``references()``, which holds each slate against the per-request
    sharded rerank on the mesh (bit for bit) and phase 14's K1 / K2
    rerank (certified near-ties), the lifecycle, and the plain update
    entry's router run against the kernel's (its lanes at their own
    counters, the ring of each lane full or not); phase 18 calls it
    while 18(b)'s children run."""
    from repro_torch.serving import DPPRerankConfig, Reranker

    c = MESH_ROUTER
    kernel = ("tiled_update_exact" if window is None
              else "tiled_update_windowed")
    part = "exact" if window is None else "windowed"
    name = f"phase 18(a) router on a mesh, {part}"
    n = c["n"] if window is None else c["n_windowed"]
    lapsed = set(int(x) for x in rng.choice(n, size=c["lapsed"],
                                             replace=False))
    reqs = router_requests(rng, catalog, n, k_lo, k_hi, lapsed)
    print(f"[{name}] {n} requests (pools "
          f"{min(r.num_candidates for r in reqs)}.."
          f"{max(r.num_candidates for r in reqs)}, k in [{k_lo}, {k_hi}], a "
          f"seen mask every third, deadlines lapsed: {sorted(lapsed)}), "
          f"{c['slots']} slots of capacity {cap}, a bucket of "
          f"{c['bucket']} columns, chunk {chunk}, window {window}, shortlist "
          f"1000, a one-rank gloo mesh on the card; the first {c['burst']} "
          f"in a burst, then {c['per_pump']} a pump", flush=True)
    t0 = time.perf_counter()
    (rr, (handles, peak, overlap)), counts, _, spans, rebuilds, wall = \
        mesh_router_run(mesh, reqs, window, cap, chunk)
    st = rr.router.stats
    busy = sum(1 for sp in spans if sp["name"] == "router.pump.launch"
               and sp["attrs"]["lanes"] > 0)
    check(counts == {kernel: chunk * st.chunks_launched}
          and busy == st.chunks_launched,
          f"{name}: launches {counts}, router_chunks_launched_total "
          f"{st.chunks_launched}, pumps with active lanes {busy}: expected "
          f"{chunk} update launches a pump with live lanes")
    check(rebuilds["slot_state_allocs_total"] == 1,
          f"{name}: rebuilds {rebuilds}: expected one slot-state allocation")
    records.setdefault(kernel, {"launches": 0})["launches"] += counts[kernel]
    mean, parts, npump = pump_split(spans)
    ttfc = np.array([h.ttfc for h in handles if h.ttfc is not None])
    dev = device_ms(lambda: mesh_router_run(mesh, reqs, window, cap, chunk),
                    kernel, counts[kernel], reps=1)
    print(f"  main path: {wall * 1e3:.1f} ms host wall, launches {counts} "
          f"({chunk} a pump with live lanes, {st.chunks_launched} such "
          f"pumps); host wall a pump: {mean:.1f} us over {npump} pumps ("
          + ", ".join(f"{p} {parts[p]:.1f}" for p in PUMP_SPANS)
          + " us); TTFC mean {:.3f} ms, p99 {:.3f} ms; fill ratio {:.3f}; "
          "peak concurrency {}; {} device time by torch.profiler {} for {} "
          "launches{}; measured in {:.1f} s".format(
              ttfc.mean() * 1e3, np.percentile(ttfc, 99) * 1e3,
              st.fill_ratio, peak, kernel, ms_text(dev), counts[kernel],
              "" if dev is None else
              f", {dev / st.chunks_launched:.4f} ms a pump with live lanes "
              f"({dev / counts[kernel]:.4f} ms a launch)",
              time.perf_counter() - t0), flush=True)

    def references():
        t1 = time.perf_counter()
        ref = [tuple(x.cpu().numpy() for x in rr.rerank(r)) for r in reqs]
        kcfg = DPPRerankConfig(slate_size=cap, shortlist=1000, alpha=ALPHA,
                               eps=EPS, window=window, use_kernel=True)
        rk = Reranker(kcfg, device="cuda")
        stops = sum(1 for i, (ei, _) in enumerate(ref)
                    if i not in lapsed and (ei < 0).any())
        want = dict(submitted=n, admitted=n - len(lapsed),
                    completed=n - len(lapsed), timed_out=len(lapsed),
                    eps_stopped=stops, rejected=0)
        got = {key: getattr(st, key) for key in want}
        check(got == want,
              f"{name}: lifecycle {got}, the inputs force {want}")
        diverged = 0
        for i, (h, r) in enumerate(zip(handles, reqs)):
            if i in lapsed:
                check(h.timed_out and len(h.slate()[0]) == 0,
                      f"{name}: request {i} (lapsed) was served")
                continue
            gi, gd = h.slate()
            check(h.done and not h.timed_out
                  and same_slate((gi, gd), ref[i]),
                  f"{name}: request {i}'s slate differs from its sharded "
                  f"rerank on the mesh")
            want_k = tuple(x.cpu().numpy() for x in rk.rerank(r))
            diverged += hold_slate(f"{name} request {i} vs "
                                   f"{'K1' if window is None else 'K2'}", rk,
                                   r, (gi, gd), want_k, window, False)[0]
        print(f"  {name}: lifecycle {got}; every slate equals the request's "
              f"sharded rerank on the mesh index for index and d_hist bit "
              f"for bit; {n - len(lapsed) - diverged} of {n - len(lapsed)} "
              f"equal phase 14's per-request "
              f"{'K1' if window is None else 'K2'} rerank index for index, "
              f"the rest certified ({time.perf_counter() - t1:.1f} s)",
              flush=True)
        t1 = time.perf_counter()
        (_, (plain, _, _)), pcounts, *_ = mesh_router_run(
            mesh, reqs, window, cap, chunk, plain=True)
        check(not pcounts, f"{name}: the plain run launched {pcounts}")
        err = 0.0
        for i, (h, p) in enumerate(zip(handles, plain)):
            if i not in lapsed:
                err = max(err, hold_slate(
                    f"{name} {kernel} vs plain, request {i}", rk, reqs[i],
                    h.slate(), p.slate(), window, False)[1])
        rec = records[kernel]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        print(f"  {kernel} vs plain at the router's shapes ({c['slots']} "
              f"lanes x {c['bucket']} columns, per-lane step counters): "
              f"every slate equal or certified, d_hist max abs err "
              f"{err:.3g} ({time.perf_counter() - t1:.1f} s)", flush=True)

    return references


def run_router_mesh_b(records, refs, rng, meanwhile):
    """18(b): ``serve_sharded --router`` on 24 requests of phase 1's
    catalog (two lapsed deadlines, one that lapses mid-flight), 8 slots,
    chunk 8, exact and w = 10: one NCCL rank and 2 gloo ranks sharing the
    card, at once, while this process runs ``meanwhile()``.  Every rank's handles equal rank 0's (the child
    raises otherwise); the two runs agree wherever neither timed out;
    each slate is held against phase 1's per-request rerank (K1 / K2,
    certified near-ties).  (18(a) holds the router against the
    per-request sharded rerank; ``--check`` would repeat that here at
    about 0.7 s a windowed request.)"""
    from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

    cb = MESH_ROUTER_B
    n = cb["n"]
    with np.load(refs["b"]["npz"]) as z:
        feats = z["feats"]
    M = feats.shape[0]
    scores = rng.uniform(size=(n, M)).astype(np.float32)
    mask = rng.uniform(size=(n, M)) >= 0.1
    mask[np.arange(n) % 3 != 2] = True
    sizes = np.exp(rng.uniform(np.log(500), np.log(M), size=n)).astype(
        np.int64)
    sizes[0] = M
    dls = np.zeros(n)
    dls[list(cb["lapsed"])] = 1e-9
    dls[cb["midflight"]] = cb["midflight_s"]
    npz = refs["work"] / "router18b.npz"
    np.savez(npz, scores=scores, feats=feats, mask=mask, sizes=sizes,
             deadlines=dls)
    print(f"[phase 18(b)] serve_sharded --router {n} on phase 1's catalog "
          f"(pools {sizes.min()}..{sizes.max()}, k 25..50 exact and "
          f"100..200 at w=10, deadlines lapsed: {list(cb['lapsed'])}, "
          f"request {cb['midflight']} given {cb['midflight_s']} s), "
          f"{cb['slots']} slots, chunk {cb['chunk']}; 1 rank "
          f"under {SHARDED_A_BACKEND} and 2 under gloo sharing the card, at "
          f"once, while 18(a)'s references run", flush=True)
    t0 = time.perf_counter()
    extra = ["--router", str(n), "--slots", str(cb["slots"]), "--chunk",
             str(cb["chunk"]), "--seed", str(SEED + 18)]
    children = [start_child(f"phase 18(b) {P} rank(s), {backend}", npz, P,
                            backend, 1000, extra=extra)
                for P, backend in ((1, SHARDED_A_BACKEND), (2, "gloo"))]
    try:
        meanwhile()
    except BaseException:
        for child in children:  # no child outlives a failed phase
            child[3].kill()
            child[3].communicate()
        raise
    catalog = torch.from_numpy(feats).to("cuda")
    recs = [finish_child(child) for child in children]
    for child, rec in zip(children, recs):
        name = child[0]
        for run, k in zip(rec["runs"], (50, 200)):
            w = run["window"]
            kernel = ("tiled_update_exact" if w is None
                      else "tiled_update_windowed")
            check(run["ranks_agree"]
                  and [run["timed_out"][i] for i in cb["lapsed"]]
                  == [True] * len(cb["lapsed"]),
                  f"{name}: window {w}: timed out {run['timed_out']}")
            mid = cb["midflight"]
            # on several ranks the lapse mid-flight is the evidence that
            # an active lane's expiry keeps the ranks in step
            check(len(run["ranks"]) == 1 or (
                run["timed_out"][mid]
                and 0 < run["delivered"][mid] < run["slate_sizes"][mid]),
                f"{name}: window {w}: request {mid} (deadline "
                f"{cb['midflight_s']} s) timed out {run['timed_out'][mid]} "
                f"after {run['delivered'][mid]} of "
                f"{run['slate_sizes'][mid]} picks: its deadline did not "
                f"lapse mid-flight")
            kcfg = DPPRerankConfig(slate_size=k, shortlist=1000,
                                   alpha=ALPHA, eps=EPS, window=w,
                                   use_kernel=True)
            rk = Reranker(kcfg, device="cuda")
            diverged = 0
            for i in range(n):
                if run["timed_out"][i]:
                    continue
                m = int(sizes[i])
                req = RerankRequest(
                    scores=torch.from_numpy(scores[i, :m].copy()).to("cuda"),
                    feats=catalog[:m],
                    mask=torch.from_numpy(mask[i, :m].copy()).to("cuda"),
                    slate_size=run["slate_sizes"][i])
                kk = run["slate_sizes"][i]
                got = (np.asarray(run["indices"][i][:kk], np.int32),
                       np.asarray(run["d_hist"][i][:kk], np.float32))
                want = tuple(x.cpu().numpy() for x in rk.rerank(req))
                diverged += hold_slate(f"{name} window {w} request {i}", rk,
                                       req, got, want, w, False)[0]
            for r in run["ranks"]:
                check(sum(r["launches"].values())
                      == cb["chunk"] * r["chunks_launched"]
                      and set(r["launches"]) == {kernel},
                      f"{name}: rank {r['rank']} launched {r['launches']} "
                      f"for {r['chunks_launched']} pumps with live lanes")
                records[kernel]["launches"] += r["launches"][kernel]
            served = [i for i in range(n) if not run["timed_out"][i]]
            head = run["ranks"][0]
            ttfc = np.array([x for x in head["ttfc_s"] if x is not None])
            share = ", ".join(
                f"rank {r['rank']} {r['decisions']} decisions, "
                f"{r['pump_us']['decide']:.1f} us a pump, "
                f"{r['pump_us']['decide'] / r['pump_us']['pump']:.2%} of a "
                f"pump's {r['pump_us']['pump']:.1f} us" for r in run["ranks"])
            print(f"  {name}, window {w}: {run['pumps']} pumps; every rank's "
                  f"handles equal rank 0's; timed out "
                  f"{[i for i in range(n) if run['timed_out'][i]]} "
                  f"(request {cb['midflight']} delivered "
                  f"{run['delivered'][cb['midflight']]} of "
                  f"{run['slate_sizes'][cb['midflight']]}); of "
                  f"{len(served)} slates {len(served) - diverged} equal the "
                  f"per-request "
                  f"{'K1' if w is None else 'K2'} rerank, the rest "
                  f"certified; TTFC mean {ttfc.mean() * 1e3:.3f} ms, p99 "
                  f"{np.percentile(ttfc, 99) * 1e3:.3f} ms (rank 0); the "
                  f"decision collective: {share}", flush=True)
    for run, run1 in zip(recs[1]["runs"], recs[0]["runs"]):
        both = [i for i in range(n)
                if not (run["timed_out"][i] or run1["timed_out"][i])]
        check(all(run["indices"][i] == run1["indices"][i] for i in both),
              f"phase 18(b): window {run['window']}: the gloo ranks' slates "
              f"differ from the NCCL rank's")
        print(f"  phase 18(b), window {run['window']}: the 2 gloo ranks' "
              f"slates equal the NCCL rank's for the {len(both)} requests "
              f"neither timed out", flush=True)
    print(f"  phase 18(b) took {time.perf_counter() - t0:.1f} s", flush=True)


def run_router_mesh(records, refs, mesh):
    """Phase 18: the continuous-batching router on the candidate-sharded
    mesh.  (a) in this process on 16(c)'s one-rank gloo group, exact and
    windowed, measured first; (b) ``serve_sharded --router`` as child
    processes, while (a)'s references run here."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 18)
    catalog = torch.from_numpy(
        rng.standard_normal(size=(100_000, D), dtype=np.float32)).to("cuda")
    catalog /= catalog.norm(dim=1, keepdim=True)
    checks = [run_router_mesh_a(records, mesh, catalog, rng, None, 50, 25,
                                50, 8),
              run_router_mesh_a(records, mesh, catalog, rng, 10, 200, 100,
                                200, 16)]
    run_router_mesh_b(records, refs, rng,
                      lambda: [references() for references in checks])
    print(f"  phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 19: measured tile choice (tile_m="auto", DPP_TILE_M) on K3-K6
# ---------------------------------------------------------------------------

TILE_AIM_S = 30.0
TILE_DEVICE_REPS = 3


def drive_tile(fn):
    """One main-path run ``fn()`` with the launch counters and the obs
    registry reset right before and read right after: (fn's result, the
    launches, the tile counters' snapshots, the dispatch's ``dpp_tile_m``
    gauge)."""
    from repro_torch import obs
    from repro_torch.kernels import cuda

    obs.disable()
    obs.enable(obs.ObsConfig(enabled=True))
    cuda.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    reg = obs.registry()
    snap = {name: reg.counter(name)._snapshot() for name in (
        "dpp_kernel_dispatch_total", "autotune_cache_hits_total",
        "autotune_cache_misses_total", "dpp_tile_source_total",
        "dpp_tile_override_total")}
    tile = reg.gauge("dpp_tile_m").value()
    obs.disable()
    return out, counts, snap, tile


def check_bits(name, got, want):
    """``got`` must equal ``want`` index for index and d_hist bit for bit."""
    check(torch.equal(got[0], want[0]), f"{name}: slate differs from the "
                                        f"model tile's")
    check(torch.equal(got[1], want[1]),
          f"{name}: d_hist differs from the model tile's by "
          f"{(got[1] - want[1]).abs().max().item()}")


def add_launches(records, counts):
    for kernel, n in counts.items():
        records.setdefault(kernel, {"launches": 0})["launches"] += n


def sweep_line(r):
    c = r["case"]
    cand = ", ".join(f"{t}: {us:.1f}" for t, us in
                     sorted(r["candidates"].items()))
    return (f"  19(a) {c.family} D={c.D} M={c.M} rows={c.state_rows} "
            f"lanes={c.lanes}{f' chunk={c.chunk}' if c.chunked else ''}: "
            f"tile {r['tile_m']} at {r['best_us']:.1f} us; every candidate "
            f"(tile: us, best of 3 CUDA event pairs around one dispatch) "
            f"{cand}")


def tile_times(swept, model, device_of, kernel, where):
    """One line: the sweep's time (CUDA events around one dispatch at the
    sweep case's shape) at its tile and at the model's, and where the two
    tiles differ the device time of the main path's call at each
    (``device_of(tile)``, torch.profiler)."""
    cand, tile = swept["candidates"], swept["tile_m"]
    at_model = ("not swept" if model not in cand else
                f"{cand[model]:.1f} us")
    text = (f"  {kernel} at {where}: the sweep's tile {tile} "
            f"{cand[tile]:.1f} us, the model's {model} {at_model} a dispatch "
            f"of its case")
    if tile == model:
        return text + "; the same tile, so the main path is unchanged"
    dev = {t: device_of(t) for t in (tile, model)}
    return (text + f"; device time by torch.profiler of the main path's "
            f"call {ms_text(dev[tile])} at {tile}, {ms_text(dev[model])} at "
            f"{model}")


def run_measured_tile(records, refs):
    """Phase 19 (aim 30 s): (a) the sweep of ``smoke_cases()`` and phases
    3/4/8's serving shape into this run's cache; (b) fig9 ``--smoke`` with
    its four gates; (c) phase 3's and phase 4's request and one single
    request of that pool through ``Reranker(..., tile_m="auto")``, and
    phase 8's chunks under ``"auto"``, each equal to the model tile's
    slate bit for bit, timed against the model's tile; (d) phase 6's
    stream under ``"auto"``; (e) ``DPP_TILE_M=256`` on phase 1's inputs
    against phase 5."""
    from repro_torch.figures import fig9_autotune
    from repro_torch.figures.common import launch_delta
    from repro_torch.kernels import cuda
    from repro_torch.kernels.dpp_greedy import autotune as tat
    from repro_torch.kernels.dpp_greedy import tiled as tm
    from repro_torch.kernels.dpp_greedy.tiling import DEFAULT_TILE_M
    from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

    t0 = time.perf_counter()
    print(f"[phase 19 measured tile] cache {os.environ[tat.CACHE_ENV]}, "
          f"DPP_TILE_M unset", flush=True)
    results, _ = tat.run_sweep(tat.smoke_cases() + tat.serving_cases(),
                               trials=3, device="cuda")
    for r in results:
        print(sweep_line(r), flush=True)
    swept = {(r["case"].family, r["case"].D, r["case"].lanes): r
             for r in results}
    print(f"  19(a) sweep: {time.perf_counter() - t0:.1f} s", flush=True)

    t1 = time.perf_counter()
    before = cuda.launch_counts()
    fig9_autotune.main(fast_mode=True, device=torch.device("cuda"))
    fig9 = launch_delta(before, cuda.launch_counts())
    add_launches(records, fig9)
    print(f"  19(b) fig9 --smoke: its four gates hold on the card "
          f"(tolerance 2.0, hits, no rebuild, parity); launches {fig9}; "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    # (c) phase 3's and phase 4's request under "auto"
    a = refs["a"]
    scores, feats, mask = a["req"]
    B, _, C = a["V"].shape
    for kernel, fam, window in (
        ("tiled_step_exact", "step_exact", None),
        ("tiled_step_windowed", "step_windowed", 10),
    ):
        name = f"19(c) phase {3 if window is None else 4} under auto"
        want = a["out"][window]
        k = want[0].shape[1]
        rr = Reranker(DPPRerankConfig(
            slate_size=k, window=window, use_kernel=True, shortlist=C,
            alpha=ALPHA, eps=EPS, tile_m="auto"), device="cuda")
        V, m_top = a["V"], a["m_top"]
        for single, req, ref in (
            (False, RerankRequest(scores=scores, feats=feats, mask=mask),
             want),
            (True, RerankRequest(scores=scores[0], feats=feats,
                                 mask=mask[0]),
             (want[0][:1], want[1][:1])),
        ):
            lanes = 1 if single else B
            label = f"B = {lanes}"
            ours = swept[fam, D, lanes]
            out, counts, snap, tile = drive_tile(lambda: rr.rerank(req))
            check(counts == {kernel: k},
                  f"{name} {label}: launches {counts}, expected {k}")
            check(snap["autotune_cache_hits_total"] == {"kind=exact": 1},
                  f"{name} {label}: lookups {snap}")
            check(tile == ours["tile_m"],
                  f"{name} {label}: tile {tile}, swept at {lanes} lanes "
                  f"{ours['tile_m']}")
            got = (out[0][None], out[1][None]) if single else out
            check_bits(f"{name} {label}", got, ref)
            add_launches(records, counts)
            print(f"  {name} {label}: tile {int(tile)} (the sweep's at "
                  f"{lanes} lane{'s' * (lanes > 1)}, an exact hit), launches "
                  f"{counts}; slate and d_hist equal phase "
                  f"{3 if window is None else 4}'s at tile {DEFAULT_TILE_M} "
                  f"bit for bit", flush=True)
            Vl, ml = (V[:1], m_top[:1]) if single else (V, m_top)
            print(tile_times(ours, DEFAULT_TILE_M, lambda t: device_ms(
                lambda: tm.dpp_greedy_tiled(Vl, ml, k, window, EPS, t),
                kernel, k, reps=TILE_DEVICE_REPS), kernel,
                f"phase {3 if window is None else 4}'s shape (B = {lanes}, "
                f"C = {C}, k = {k})"), flush=True)

    # phase 8's chunks under "auto" (K5 / K6 at phase 3/4's shape)
    for kernel, fam, window in (
        ("fused_chunk_exact", "chunk_exact", None),
        ("fused_chunk_windowed", "chunk_windowed", 10),
    ):
        name = f"19(c) phase 8 {'exact' if window is None else 'windowed'} " \
               f"under auto"
        V, m_top = a["V"], a["m_top"]
        k = a["direct"][window][0].shape[1]
        n = -(-k // 16)
        got, counts, snap, tile = drive_tile(
            lambda: stream_slate(V, m_top, k, window, 16, "auto"))
        check(counts == {kernel: n}, f"{name}: launches {counts}")
        check(snap["autotune_cache_hits_total"] == {"kind=exact": 1},
              f"{name}: lookups {snap}")
        check_bits(name, got, a["direct"][window])
        add_launches(records, counts)
        line = chunk_tiles(C, window or k, window is not None, B,
                           V.device)[0]
        print(f"  {name}: tile {int(tile)} (the sweep's), launches "
              f"{counts}; slate and d_hist equal phase "
              f"{3 if window is None else 4}'s bit for bit; the model's "
              f"tiling: {line}", flush=True)
        model = tat.model_tile(D, C, window or k, window is not None, True,
                               B, tm.capacity_fn(window is not None,
                                                 V.device))
        print(tile_times(swept[fam, D, B], model, lambda t: device_ms(
            lambda: stream_slate(V, m_top, k, window, 16, t), kernel, n,
            reps=TILE_DEVICE_REPS), kernel,
            f"phase 8's shape (B = {B}, C = {C}, k = {k}, chunk 16)"),
            flush=True)

    # (d) phase 6's stream under "auto"
    p1_scores, p1_feats, p1_out = refs["p1"]
    k = p1_out[0].shape[1]
    rr = Reranker(DPPRerankConfig(slate_size=k, shortlist=1000, alpha=ALPHA,
                                  eps=EPS, use_kernel=True, tile_m="auto"),
                  device="cuda")
    req = RerankRequest(scores=p1_scores[0], feats=p1_feats)
    parts, counts, snap, tile = drive_tile(
        lambda: list(rr.stream(req, chunk_size=8)))
    check(counts == {"fused_chunk_exact": -(-k // 8)},
          f"19(d) stream under auto: launches {counts}")
    got = (torch.cat([p[0] for p in parts])[None],
           torch.cat([p[1] for p in parts])[None])
    check_bits("19(d) phase 6 under auto", got, refs["p6"])
    add_launches(records, counts)
    looked = (snap["autotune_cache_hits_total"]
              or snap["autotune_cache_misses_total"]
              or "none: the model keeps one whole-M tile")
    print(f"  19(d) phase 6's stream under auto: tile {int(tile)} (lookup "
          f"{looked}), launches {counts}; slate and d_hist equal phase 6's "
          f"bit for bit", flush=True)

    # (e) DPP_TILE_M=256 on phase 1's inputs against phase 5
    rr = Reranker(DPPRerankConfig(use_kernel=True, shortlist=1000,
                                  slate_size=k, alpha=ALPHA, eps=EPS,
                                  tile_m=512), device="cuda")
    os.environ["DPP_TILE_M"] = "256"
    try:
        out, counts, snap, tile = drive_tile(lambda: rr.rerank(
            RerankRequest(scores=p1_scores, feats=p1_feats)))
    finally:
        os.environ.pop("DPP_TILE_M", None)
    check(counts == {"tiled_step_exact": k},
          f"19(e) DPP_TILE_M=256: launches {counts}")
    check(snap["dpp_tile_override_total"]
          == {"lost=explicit,winner=env": 1} and tile == 256,
          f"19(e) DPP_TILE_M=256: tile {tile}, counters {snap}")
    check_bits("19(e) DPP_TILE_M=256 vs phase 5", out, p1_out)
    add_launches(records, counts)
    print(f"  19(e) DPP_TILE_M=256 over tile_m=512 on phase 1's inputs: tile "
          f"256, dpp_tile_override_total "
          f"{snap['dpp_tile_override_total']}, launches {counts}; slate and "
          f"d_hist equal phase 5's (= phase 1's) bit for bit", flush=True)
    took = time.perf_counter() - t0
    print(f"  phase 19: {took:.1f} s (aim {TILE_AIM_S:.0f} s)", flush=True)


# ---------------------------------------------------------------------------
# Phase 20: the static checks and Figure 8 on the card
# ---------------------------------------------------------------------------

STATIC_AIM_S = 20.0


def run_static_checks(records):
    """Phase 20 (aim 20 s): (a) the port's static checks with the card's
    capacities, zero findings; (b) Figure 8 ``--full`` on the card, its
    gates, its pump split and its K5 launches."""
    from repro_torch import obs
    from repro_torch.analysis import run_analysis
    from repro_torch.analysis.cli import summary_line
    from repro_torch.analysis.kernels import COOPERATIVE, card_capacities
    from repro_torch.figures import fig8_observability as fig8
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    name = "phase 20(a) static checks"
    paths = [str(ROOT / "src" / "repro_torch"), str(ROOT / "chip_smoke.py")]
    print(f"[{name}] python -m repro_torch.analysis over {len(paths)} "
          f"paths, kernel contracts on the card's capacity queries",
          flush=True)
    findings, summary = run_analysis(paths, capacities=card_capacities(dev))
    check(not findings, f"{name}: {len(findings)} finding(s):\n"
          + "\n".join(f.format() for f in findings))
    print("  " + summary_line(findings, summary), flush=True)
    for fam, got in summary["kernel_contracts"]["per_family"].items():
        line = (f"  {fam}: {got['geometries']} geometries, "
                f"{got['refused']} refused by the policy")
        if fam in COOPERATIVE:
            line += (f"; largest cooperative grid {got['largest_grid']} "
                     f"blocks against {got['co_resident']} co-resident")
        print(line, flush=True)
    t_a = time.perf_counter() - t0

    name = "phase 20(b) fig8"
    print(f"[{name}] Figure 8 at its --full size on the card", flush=True)
    cuda.reset_launch_counts()
    try:
        rows, failures, slates = fig8.run(False, device=dev)
        torch.cuda.synchronize()
    finally:
        obs.disable()
    counts = cuda.launch_counts()
    check(not failures, f"{name}: gate failures {failures}")
    check(set(counts) == {"fused_chunk_exact", "dpp_greedy_resident"},
          f"{name}: launches {counts}")
    check(counts["dpp_greedy_resident"] == len(slates),
          f"{name}: {counts['dpp_greedy_resident']} K1 reranks for "
          f"{len(slates)} slates")
    records["fused_chunk_exact"]["launches"] += counts["fused_chunk_exact"]
    by_name = {row[0]: row for row in rows}
    for phase in fig8.PUMP_PHASES + ("sync",):
        _, us, derived = by_name[f"fig8_pump_{phase}"]
        share = dict(kv.split("=") for kv in derived.split(";"))["share"]
        print(f"  pump {phase}: {us:.1f} us mean, {share} of the pump",
              flush=True)
    for row in rows:
        print(f"  {row[0]},{row[1]:.1f},{row[2]}", flush=True)
    print(f"  launches {counts}: K5 the router (warm set and drive) and the "
          f"per-k serial streams, every router slate equal to its K1 "
          f"rerank index for index and d_hist bit for bit, every stream a "
          f"prefix of it", flush=True)
    took = time.perf_counter() - t0
    print(f"  phase 20: {took:.1f} s ((a) {t_a:.1f} s; aim "
          f"{STATIC_AIM_S:.0f} s)", flush=True)


def update_times():
    """``--update-times``: the shard-local update entries alone at 16(c)'s
    shape (B = 4, D = 100, C = 65,536 of a 10^6 pool with a 10% seen
    mask; exact k = 50, w = 10 k = 200) through ``core.sharded.
    greedy_local`` on a one-rank gloo group: torch.profiler's device time
    of a slate's k launches (median of 5).  Whatever ``repro_torch`` sits
    beside the script is timed, so a copy of this script in another
    tree's root times that tree's entries the same way."""
    from repro_torch.core.sharded import greedy_local
    from repro_torch.serving import DPPRerankConfig
    from repro_torch.serving.reranker import _shortlist_kernel

    rng = np.random.default_rng(SEED + 3)
    scores, feats, mask = make_inputs(rng, 4, 1_000_000, seen_frac=0.1)
    V, m_top, _ = _shortlist_kernel(
        scores, feats, DPPRerankConfig(shortlist=65536, alpha=ALPHA,
                                       eps=EPS), mask)
    del scores, feats, mask
    C = V.shape[2]
    work = Path(tempfile.mkdtemp(prefix="update_times_"))
    out = {}
    try:
        with one_rank_group(work) as mesh:
            for kernel, k, w in (("tiled_update_exact", 50, None),
                                 ("tiled_update_windowed", 200, 10)):
                def run():
                    return greedy_local(V, m_top, k, mesh=mesh, base=3 * C,
                                        window=w, eps=EPS)
                dev = device_ms(run, kernel, k, reps=5)
                out[kernel] = dev
                print(f"  {kernel}: B=4 C={C} k={k} window={w}: device "
                      f"time {ms_text(dev)} for {k} launches", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("update_times " + json.dumps(out), flush=True)


def resident_times():
    """``--resident-times``: K1 and K2 alone, one launch each at phases 1
    and 2's kernel shapes (the same seeded shortlists: B = 64, C = 1000,
    D = 100; k = 50 exact, k = 200 at w = 10) and K1 at the recsys
    reranks' shapes (D = 10 unit-norm Gaussian features: B = 512, C =
    200, k = 10 as phase 10; B = 1, C = 1000, k = 50 as phase 11): CUDA
    event time (median of TIMING_REPS), device time by torch.profiler and
    the wrapper's host time, their difference.  Whatever ``repro_torch``
    sits beside the script is timed, so a copy of this script run from
    another tree's root times that tree's kernels the same way."""
    from repro_torch.kernels.dpp_greedy.dpp_greedy import (
        dpp_greedy_resident,
        dpp_greedy_resident_windowed,
        init_gains,
    )
    from repro_torch.serving import DPPRerankConfig
    from repro_torch.serving.reranker import _shortlist_kernel

    def shortlist(rng, B, M, C, width):
        scores = rng.uniform(size=(B, M)).astype(np.float32)
        feats = rng.standard_normal(size=(M, width), dtype=np.float32)
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        V, _, _ = _shortlist_kernel(
            torch.from_numpy(scores).to("cuda"),
            torch.from_numpy(feats).to("cuda"),
            DPPRerankConfig(shortlist=C, alpha=ALPHA, eps=EPS), None)
        return V, init_gains(V, torch.ones(V.shape[0], V.shape[2],
                                           dtype=torch.bool, device="cuda"))

    V, d2 = shortlist(np.random.default_rng(SEED), 64, 100_000, 1000, D)
    V10, d10 = shortlist(np.random.default_rng(SEED + 10), 512, 2000, 200,
                         10)
    V11, d11 = shortlist(np.random.default_rng(SEED + 11), 1, 100_000, 1000,
                         10)
    out = {}
    for label, kernel, fn in (
        ("phase 1", "dpp_greedy_resident",
         lambda: dpp_greedy_resident(V, d2, 50, EPS)),
        ("phase 1 single request", "dpp_greedy_resident",
         lambda: dpp_greedy_resident(V[:1], d2[:1], 50, EPS)),
        ("phase 2", "dpp_greedy_resident_windowed",
         lambda: dpp_greedy_resident_windowed(V, d2, 200, 10, EPS)),
        ("phase 10 shape", "dpp_greedy_resident",
         lambda: dpp_greedy_resident(V10, d10, 10, EPS)),
        ("phase 11 shape", "dpp_greedy_resident",
         lambda: dpp_greedy_resident(V11, d11, 50, EPS)),
    ):
        ms = time_events(lambda: event_ms(fn), TIMING_REPS)
        dev = device_ms(fn, kernel, 1, cuda_name=RESIDENT_CUDA[kernel])
        host = None if dev is None else (ms - dev) * 1e3
        out[label] = {"kernel": kernel, "ms": ms, "device_ms": dev,
                      "host_us": host}
        print(f"  {label}, {kernel}: {ms:.4f} ms (CUDA events), device "
              f"{ms_text(dev)}, host "
              + ("not measured" if host is None else f"{host:.1f} us"),
              flush=True)
    print("resident_times " + json.dumps(out), flush=True)


def run_phases(records, rng, refs):
    """Phases 1-20 in order, each adding to ``records``; ``refs`` carries
    phases 16, 17 and 19's requests and references (its ``work`` directory
    holds the requests' files)."""
    t0 = time.perf_counter()
    scores, feats, resident = run_resident(records, rng, refs)
    refs["p1"] = (scores, feats, resident[None][2])  # phase 19's
    records["tiled_step_exact"] = {"launches": 0}
    records["tiled_step_exact"]["launches"] += run_forced_tile(
        resident[None][2], resident[None][0], scores, feats)
    pool_state = rng.bit_generator.state  # phase 3 draws its pool from here
    tiled, pool = run_tiled(records, rng, refs)
    refs["p6"] = run_stream(records, resident, scores, feats)
    del scores, feats
    run_chunks_windowed(records, resident)
    run_chunks_large(records, tiled)
    run_slots(records, resident)
    small_reference_check(rng)
    del resident, tiled
    model, cfg, user, cand, scores, slates, feats, rr_cfg = run_recsys_serve(
        records)
    run_retrieval(records, model, cfg)
    recsys_reference_check(model, cfg, user, cand, scores, slates, feats,
                           rr_cfg)
    run_scored_topk(records, pool, pool_state)
    run_paper_experiments(records)
    run_router(records, rng, model.to("cuda"))
    del model
    run_sessions(records, rng)
    with one_rank_group(refs["work"]) as mesh:
        run_sharded(records, refs, mesh)
        run_sharded_stream(records, refs, mesh)
        run_router_mesh(records, refs, mesh)
    run_measured_tile(records, refs)
    run_static_checks(records)
    print(f"phases done in {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    # no phase may depend on the machine's tile settings: the process-wide
    # tile override is dropped and the autotune cache is this run's own
    # file (phase 19 sweeps into it)
    os.environ.pop("DPP_TILE_M", None)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    os.environ["DPP_AUTOTUNE_CACHE"] = str(work / "dpp_autotune.json")
    try:
        return run_main(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_main(work: Path) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.figures.common import device_name
    from repro_torch.kernels import cuda

    smi = device_name(torch.device("cuda", 0))
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, numpy {np.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    build_s = cuda.build_all()
    print(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, one process per "
          f"source)", flush=True)
    for log in sorted((cuda.KERNELS_DIR).glob("*/build/*.log")):
        for line in log.read_text().splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                print(f"  ptxas {log.stem[:12]}: {line.strip()}")

    if sys.argv[1:] == ["--resident-times"]:
        resident_times()
        return 0
    if sys.argv[1:] == ["--update-times"]:
        update_times()
        return 0
    if sys.argv[1:2] == ["--topk-device-times"]:
        topk_device_times(sys.argv[2])
        return 0
    rng = np.random.default_rng(SEED)
    records = {}
    run_phases(records, rng, {"work": work})

    kernels = []
    for name in KERNELS:
        rec = dict(records[name])
        rec.pop("calls_launches", None)
        kernels.append({key: rec[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms")})
    print("kernels: " + ", ".join(f"{k['name']} ok" for k in kernels))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
