#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's whole-slate DPP rerank on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch`` (nvcc, sm_90a),
then runs five phases through ``repro_torch.serving.Reranker(...,
use_kernel=True).rerank`` at the paper's §5.1 setup: D = 100
column-normalised Gaussian features, uniform relevance, alpha = 3,
eps = 1e-3, inputs made with numpy from a fixed seed.

1. resident exact:    B = 64 users, pool 100,000, shortlist 1000, k = 50,
                      plus one single request;
2. resident windowed: phase 1 with window 10, k = 200;
3. tiled exact:       B = 4 users, pool 1,000,000, shortlist 65,536,
                      k = 50, 10% of the pool masked as seen;
4. tiled windowed:    phase 3 with window 10, k = 200;
5. forced tile:       phase 1's inputs with tile_m = 256; the tiled slate
                      must equal the resident one.

Each phase resets the kernels' launch counters right before the main-path
call, reads them right after, and checks them and the mode recorded in
dispatch telemetry; holds the kernel against its plain PyTorch version on
the same inputs (d_hist rtol 3e-4 / atol 1e-5; a slate may differ only
after a float64-certified near-tie, with every later pick float64
greedy-valid); times the kernel and the plain version with CUDA events;
and checks the outputs.  Any failure exits non-zero.  The second-to-last
line is the kernels' JSON record, the last the device line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

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
}


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
    eps2 = float(np.float32(eps) * np.float32(eps))
    a, r = sel.cpu().numpy(), ref.cpu().numpy()
    lanes = [b for b in range(a.shape[0]) if (a[b] != r[b]).any()]
    for b in lanes:
        p = int(np.nonzero(a[b] != r[b])[0][0])
        V64 = V[b].double()
        diag = (V64 * V64).sum(0)
        m = (torch.ones(V.shape[2], dtype=torch.bool, device=V.device)
             if mask is None else mask[b])
        pre = torch.as_tensor(a[b, :p], dtype=torch.long, device=V.device)
        g = _gains64(V64, diag, m, pre, window)
        gmax = g.max().item()
        x, y = int(a[b, p]), int(r[b, p])
        if x < 0 or y < 0:  # one stopped: the best gain sits at eps^2
            tie = _close(gmax, eps2)
        else:
            tie = _close(g[x].item(), g[y].item())
        check(tie, f"{name}: lane {b} diverges at step {p} ({x} vs {y}) "
                   f"without a float64 near-tie")
        for q in range(p, a.shape[1]):
            x = int(a[b, q])
            pre = torch.as_tensor(a[b, :q], dtype=torch.long, device=V.device)
            g = _gains64(V64, diag, m, pre, window)
            gmax = g.max().item()
            if x < 0:
                check(gmax <= eps2 or _close(gmax, eps2),
                      f"{name}: lane {b} stops at step {q} with gain {gmax}")
                check((a[b, q:] < 0).all(), f"{name}: lane {b} resumes")
                break
            check(_close(g[x].item(), gmax) or g[x].item() >= gmax,
                  f"{name}: lane {b} step {q} picks {x} (gain "
                  f"{g[x].item()}) below the float64 best {gmax}")
    return lanes


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


def phase(name, kernel, rr, scores, feats, mask, window, expect_mode,
          expect_launches, records, single=False):
    """Drive one phase end to end; return the kernel's plain-vs-kernel
    inputs so the caller can reuse them."""
    from repro_torch.serving import RerankRequest
    from repro_torch.serving.reranker import _shortlist_kernel

    cfg = rr.cfg
    k = cfg.slate_size
    B, M = scores.shape
    print(f"[{name}] B={B} pool={M} shortlist={cfg.shortlist} k={k} "
          f"window={window} tile_m={cfg.tile_m}", flush=True)
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
    print(f"  main path: {wall * 1e3:.1f} ms host wall, launches {counts}, "
          f"mode {expect_mode}, {n} items selected", flush=True)
    rec = records.setdefault(kernel, {"launches": 0})
    rec["launches"] += counts[kernel]
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


def kernel_record(records, kernel, ms, plain_ms, bnd, err, note):
    b_ms, by, nbytes, flops = bnd
    rec = records[kernel]
    rec.update(name=kernel, route="cuda", **KERNELS[kernel],
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=by, library_ms=None)
    print(f"  {kernel}: {ms:.4f} ms/call (median of {TIMING_REPS}, {note}), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {by} "
          f"({nbytes} B, {flops} FP32 FLOP), launches/call "
          f"{rec['calls_launches']}, no library call computes a greedy DPP "
          f"slate (library_ms null)", flush=True)


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
        rr = Reranker(DPPRerankConfig(slate_size=k, window=window, **base),
                      device="cuda")
        out, V, m_top, top_i = phase(
            name, kernel, rr, scores, feats, None, window, "resident", 1,
            records, single=window is None)
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
        plain_ms = time_events(lambda: event_ms(pfn), PLAIN_REPS)
        records[kernel]["calls_launches"] = 1
        kernel_record(records, kernel, ms, plain_ms,
                      bound(B, D, C, k, window, (got[0] >= 0).sum(1)), err,
                      "one launch, CUDA events")
        results[name] = (rr, out)
    return scores, feats, results["phase 1 resident exact"][1]


def run_tiled(records, rng):
    from repro_torch.kernels.dpp_greedy import tiled as tm
    from repro_torch.kernels.dpp_greedy.tiling import TilePolicy
    from repro_torch.serving import DPPRerankConfig, Reranker

    B, M, C = 4, 1_000_000, 65536
    scores, feats, mask = make_inputs(rng, B, M, seen_frac=0.1)
    base = dict(use_kernel=True, shortlist=C, alpha=ALPHA, eps=EPS)
    for name, kernel, k, window in (
        ("phase 3 tiled exact", "tiled_step_exact", 50, None),
        ("phase 4 tiled windowed", "tiled_step_windowed", 200, 10),
    ):
        rr = Reranker(DPPRerankConfig(slate_size=k, window=window, **base),
                      device="cuda")
        out, V, m_top, top_i = phase(
            name, kernel, rr, scores, feats, mask, window, "tiled", k,
            records)
        tile = TilePolicy().decide(D, C, window or k, windowed=window
                                   is not None)[1]
        # kernel vs plain: the same whole-slate loop with the plain steps
        got = tm.dpp_greedy_tiled(V, m_top, k, window, EPS, tile)
        real = getattr(tm, kernel)
        plain = getattr(tm, kernel + "_plain")
        setattr(tm, kernel, plain)
        try:
            want = tm.dpp_greedy_tiled(V, m_top, k, window, EPS, tile)
        finally:
            setattr(tm, kernel, real)
        torch.cuda.synchronize()
        check(torch.equal(
            torch.where(got[0] >= 0,
                        top_i.gather(1, got[0].long().clamp_min(0)), -1)
            .to(torch.int32), out[0]),
            f"{name}: direct kernel call differs from the main path")
        _, err = compare(name, V, m_top, got, want, window, EPS)
        ms, plain_ms = time_tiled(tm, kernel, V, m_top, k, window, tile)
        records[kernel]["calls_launches"] = k
        kernel_record(records, kernel, ms, plain_ms,
                      bound(B, D, C, k, window, (got[0] >= 0).sum(1)), err,
                      f"sum of {k} launches, CUDA events per launch")


def time_tiled(tm, kernel, V, mask, k, window, tile):
    """Kernel and plain device time of one whole-slate tiled call, each
    launch bracketed by its own CUDA events: the whole-slate loop runs
    with the step function wrapped, so the PyTorch work between the
    windowed launches is outside the sum."""
    real = getattr(tm, kernel)
    plain = getattr(tm, kernel + "_plain")
    out = []
    for fn, reps in ((real, TIMING_REPS), (plain, PLAIN_REPS)):
        acc = []

        def timed(*args, _fn=fn, **kw):
            acc.append(event_ms(lambda: _fn(*args, **kw)))

        def one():
            acc.clear()
            setattr(tm, kernel, timed)
            try:
                tm.dpp_greedy_tiled(V, mask, k, window, EPS, tile)
            finally:
                setattr(tm, kernel, real)
            return sum(acc)

        out.append(time_events(one, reps))
    return out


def run_forced_tile(resident_out, scores, feats):
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
    check(torch.allclose(out[1], resident_out[1], rtol=RTOL, atol=ATOL),
          f"phase 5: d_hist differs from resident by {err}")
    print(f"  launches {counts}; slate equals phase 1's resident slate; "
          f"d_hist max abs diff {err:.3g}", flush=True)
    return counts["tiled_step_exact"]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    build_s = cuda.build_all()
    print(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, one process per "
          f"source)", flush=True)
    for log in sorted((cuda.KERNELS_DIR).glob("*/build/*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {log.stem[:12]}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    records = {}
    t0 = time.perf_counter()
    scores, feats, resident_out = run_resident(records, rng)
    records["tiled_step_exact"] = {"launches": 0}
    records["tiled_step_exact"]["launches"] += run_forced_tile(
        resident_out, scores, feats)
    del scores, feats
    run_tiled(records, rng)
    small_reference_check(rng)
    print(f"phases done in {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = []
    for name in KERNELS:
        rec = dict(records[name])
        rec.pop("calls_launches")
        kernels.append({key: rec[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print("kernels: " + ", ".join(f"{k['name']} ok" for k in kernels))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
