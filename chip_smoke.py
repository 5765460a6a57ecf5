#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the DPP rerank, DeepFM
scoring into the rerank, the fused scoring top-c, and the paper's
experiments.

    python3 chip_smoke.py
    python3 chip_smoke.py --resident-times   # K1, K2 alone (resident_times)

(Phase 12 runs ``chip_smoke.py --topk-device-times STATE`` as a child
process for K7's profiler times: ``topk_device_times``.)

Builds the port's CUDA kernels from ``src/repro_torch`` (nvcc, sm_90a),
then runs thirteen phases through the port's entry points.  Phases 1-9
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

Each phase resets the kernels' launch counters right before the main-path
call, reads them right after, and checks them and the mode recorded in
dispatch telemetry; holds the kernel against its plain PyTorch version on
the same inputs (d_hist rtol 3e-4 / atol 1e-5; a slate may differ only
after a float64-certified near-tie, with every later pick float64
greedy-valid; K8 rtol 1e-5 / atol 1e-6; K7 values within 1e-5); times the
kernel and the plain version with CUDA events (the multi-launch kernels
K3-K6 one event pair per launch, summed), with torch.profiler's device
time of the same launches beside it as ``device_ms`` (K1-K7); and checks
the outputs.
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
import statistics
import subprocess
import sys
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
                  device=None):
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
    print(f"  {kernel}: {ms:.4f} ms/call (median of {TIMING_REPS}, {note}), "
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


def run_resident(records, rng):
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


def run_tiled(records, rng):
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


def stream_slate(V, mask, k, window, chunk):
    """The concatenated ``greedy_map_chunks`` slate of V (B, D, M) on the
    kernel backend: (sel (B, k), d_hist (B, k))."""
    from repro_torch.core import GreedySpec, greedy_map_chunks

    spec = GreedySpec(k=k, window=window, backend="kernel", eps=EPS)
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


def main() -> int:
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
    if sys.argv[1:2] == ["--topk-device-times"]:
        topk_device_times(sys.argv[2])
        return 0
    rng = np.random.default_rng(SEED)
    records = {}
    t0 = time.perf_counter()
    scores, feats, resident = run_resident(records, rng)
    records["tiled_step_exact"] = {"launches": 0}
    records["tiled_step_exact"]["launches"] += run_forced_tile(
        resident[None][2], resident[None][0], scores, feats)
    pool_state = rng.bit_generator.state  # phase 3 draws its pool from here
    tiled, pool = run_tiled(records, rng)
    run_stream(records, resident, scores, feats)
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
    del model
    run_scored_topk(records, pool, pool_state)
    run_paper_experiments(records)
    print(f"phases done in {time.perf_counter() - t0:.1f} s", flush=True)

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
