"""Windowed-vs-exact sweep (beyond-paper; NeurIPS'18 sliding window),
plus the past-the-resident-gate kernel sweep; the counterpart of
``repro``'s ``benchmarks/fig4_windowed.py``.

**N-sweep** — fixes the candidate set M and the window w, then grows
the slate length N up to 8x w, on the kernel backend: K2 (the resident
windowed kernel) for N > w, K1 at N = w, where the window covers the
slate.  The claim under test is the sliding window's complexity:
per-step cost O(w M), *independent of N* — the Cholesky ring ``C (w,
M)`` is fixed-size state, whereas the exact Algorithm 1 (K1, timed
beside it) carries O(N M) state.  Expected CSV shape:
``win_us_per_step`` flat in N (``win_step_vs_N<w>`` stays ~1x).

**Gate sweep** — grows M through the resident kernels' shared-memory
budget.  ``repro``'s gate is its VMEM model; the port's is the tile
policy's: a user is resident while its gains, the winner's staged
columns and, windowed, the window factor fit one thread block's
``SMEM_BUDGET_BYTES`` (``tiling.resident_smem_bytes``), and
``TilePolicy`` tiles the candidate axis past that.  Rows with
``past_gate=1`` are those where the tiled per-step kernels run (K4,
windowed: N > w); ``mode`` and ``tile_m`` are the policy's answer and
``launches`` what the kernels counted on the card.  Each row holds the
kernel slate against the torch core's index for index (``parity=ok``)
and reports ``kernel_vs_torch`` wall-clock.

  python -m repro_torch.figures.fig4_windowed [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import GreedySpec, greedy_map, map_relevance
from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    best_time,
    device_line,
    launch_delta,
    parse,
)
from repro_torch.kernels import cuda
from repro_torch.kernels.dpp_greedy import (
    SMEM_BUDGET_BYTES,
    TilePolicy,
    dpp_greedy,
)
from repro_torch.kernels.dpp_greedy.tiling import resident_smem_bytes

EPS = 1e-6
FAST_SWEEP = (400, 48, 8)  # the N-sweep's (M, D, w)
FULL_SWEEP = (1000, 100, 8)
FAST_CELLS = ((4096, 32, 8), (65536, 64, 8))
FULL_CELLS = FAST_CELLS + ((131072, 64, 8),)
GATE_K = 16


def setup(M, D, seed=0, alpha=2.0, device=None):
    """V (D, M) float32 on the device: unit-norm Gaussian columns scaled
    by ``alpha ** r``, r uniform (``repro``'s draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    F = torch.as_tensor(rng.normal(size=(D, M)), dtype=torch.float32,
                        device=dev)
    F = F / torch.clamp_min(torch.linalg.vector_norm(F, dim=0, keepdim=True),
                            1e-12)
    r = torch.as_tensor(rng.uniform(size=M), dtype=torch.float32, device=dev)
    return F * map_relevance(r, alpha)[None, :]


def run(M=1000, D=100, w=8, trials=3, device=None):
    """N-sweep rows (N, w, windowed seconds, exact seconds, slates), least
    of ``trials`` after a warm call, on the kernel backend; ``slates`` is
    ``{"windowed": (N,), "exact": (N,)}`` int numpy, the slates of
    ``setup(M, D)`` that the timed calls returned."""
    dev = resolve_device(device)
    V = setup(M, D, device=dev)
    rows = []
    for N in (w, 2 * w, 4 * w, 8 * w):
        sel = {}

        def timed(name, spec):
            def fn():
                sel[name] = greedy_map(spec, V=V).indices
            return best_time(fn, trials, dev)

        t_win = timed("windowed", GreedySpec(k=N, window=w, eps=EPS,
                                             backend="kernel"))
        t_exact = timed("exact", GreedySpec(k=N, eps=EPS, backend="kernel"))
        rows.append((N, w, t_win, t_exact,
                     {n: s.cpu().numpy() for n, s in sel.items()}))
    return rows


def run_gate(cells, k, trials, device=None):
    """cells: (M, D, w) triples; one dict a cell."""
    dev = resolve_device(device)
    rows = []
    for M, D, w in cells:
        V = setup(M, D, device=dev)[None]  # (1, D, M)
        resident = resident_smem_bytes(D, M, w, True)
        mode, tm = TilePolicy().decide(D, M, w, windowed=True)
        sel = {}

        def kernel():
            sel["kernel"] = dpp_greedy(V, k, window=w, eps=EPS)[0]

        def core():
            sel["torch"] = greedy_map(GreedySpec(k=k, window=w, eps=EPS),
                                      V=V).indices

        before = cuda.launch_counts()
        kernel()
        launches = launch_delta(before, cuda.launch_counts())
        t_k = best_time(kernel, trials, dev)
        t_j = best_time(core, trials, dev)
        same = torch.equal(sel["kernel"].cpu(), sel["torch"].cpu())
        rows.append(dict(
            M=M, D=D, w=w, k=k, past_gate=int(resident > SMEM_BUDGET_BYTES),
            resident_smem=resident, mode=mode, tile_m=tm or 0,
            t_kernel=t_k, t_torch=t_j, launches=launches,
            parity="ok" if same else "FAIL",
            slates={n: s.cpu().numpy() for n, s in sel.items()},
        ))
    return rows


def main(fast_mode=False, device=None):
    dev = resolve_device(device)
    M, D, w = FAST_SWEEP if fast_mode else FULL_SWEEP
    trials = 2 if fast_mode else 5
    rows = run(M=M, D=D, w=w, trials=trials, device=dev)
    print(device_line(dev))
    print("name,us_per_call,derived")
    base = rows[0][2] / rows[0][0]
    for N, w, t_win, t_exact, _ in rows:
        print(
            f"fig4_windowed_w{w}_N{N},{t_win*1e6:.1f},"
            f"win_us_per_step={t_win/N*1e6:.2f};"
            f"exact_us_per_step={t_exact/N*1e6:.2f};"
            f"win_step_vs_N{rows[0][0]}={t_win/N/base:.2f}x"
        )

    # gate sweep: one in-gate cell plus at least one past-the-gate cell,
    # N > w so the windowed kernel — eviction included — is what runs
    # past the gate
    cells, gtrials = (FAST_CELLS, 1) if fast_mode else (FULL_CELLS, 3)
    grows = run_gate(cells, GATE_K, gtrials, device=dev)
    for g in grows:
        launches = "+".join(f"{n}:{c}" for n, c in sorted(
            g["launches"].items())) or "none"
        print(
            f"fig4_gate_M{g['M']}_D{g['D']}_w{g['w']},{g['t_kernel']*1e6:.1f},"
            f"past_gate={g['past_gate']};mode={g['mode']};"
            f"tile_m={g['tile_m']};resident_smem_B={g['resident_smem']};"
            f"launches={launches};torch_us={g['t_torch']*1e6:.1f};"
            f"kernel_vs_torch={g['t_torch']/max(g['t_kernel'], 1e-12):.2f}x;"
            f"parity={g['parity']};N={g['k']}"
        )
    if any(g["parity"] != "ok" for g in grows):
        raise RuntimeError(
            "fig4 gate sweep parity failure: "
            f"{[(g['M'], g['D'], g['w']) for g in grows if g['parity'] != 'ok']}")
    return rows, grows


if __name__ == "__main__":
    fast, dev = parse(__doc__)
    main(fast_mode=fast, device=dev)
