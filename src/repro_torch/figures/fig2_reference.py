"""Paper Figure 2: running time of MMR, Greedy [3], and Div-DPP on the
same synthetic setup (M = 1000, D = 100) — Div-DPP must be *comparable*
to the O(MN) reference diversifiers; the counterpart of ``repro``'s
``benchmarks/fig2_reference.py``.

MMR and greedy-avg are k-step loops of eager torch ops on the device;
Div-DPP runs as the torch core (``dpp_greedy_dense`` on the dense L) and,
in the ``divdpp_kernel`` row, through the kernel backend on the low-rank
``V`` (K1 on the card, its plain version on the CPU).

  python -m repro_torch.figures.fig2_reference [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import (
    GreedySpec,
    dpp_greedy_dense,
    greedy_avg_select,
    greedy_map,
    mmr_select,
)
from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    device_line,
    mean_time,
    paper_setup,
    parse,
)

PAPER_NS = tuple(range(5, 55, 5))
FAST_NS = (5, 10, 20)
THETA = 0.5


def run(trials=10, Ns=PAPER_NS, M=1000, D=100, device=None):
    """One dict a N: the four methods' mean times in seconds after one
    warm call, and their slates ((N,) int64 numpy)."""
    dev = resolve_device(device)
    r, S, L, V = paper_setup(M, D, device=dev)
    rows = []
    for N in Ns:
        spec = GreedySpec(k=N, backend="kernel")
        fns = {
            "mmr": lambda: mmr_select(r, S, N, THETA),
            "greedy": lambda: greedy_avg_select(r, S, N, THETA),
            "divdpp": lambda: dpp_greedy_dense(L, N).indices,
            "divdpp_kernel": lambda: greedy_map(spec, V=V).indices,
        }
        times = {name: mean_time(fn, trials, dev) for name, fn in fns.items()}
        slates = {name: fn().cpu().numpy().astype(np.int64)
                  for name, fn in fns.items()}
        rows.append(dict(N=N, times=times, slates=slates))
    return rows


def main(fast_mode=False, device=None):
    dev = resolve_device(device)
    trials = 3 if fast_mode else 10
    rows = run(trials, FAST_NS if fast_mode else PAPER_NS, device=dev)
    print(device_line(dev))
    print("name,us_per_call,derived")
    for row in rows:
        N, t = row["N"], row["times"]
        print(f"fig2_mmr_N{N},{t['mmr'] * 1e6:.1f},")
        print(f"fig2_greedy_N{N},{t['greedy'] * 1e6:.1f},")
        for name in ("divdpp", "divdpp_kernel"):
            print(f"fig2_{name}_N{N},{t[name] * 1e6:.1f},"
                  f"ratio_vs_mmr={t[name] / max(t['mmr'], 1e-12):.2f}")
    return rows


if __name__ == "__main__":
    fast, dev = parse(__doc__)
    main(fast_mode=fast, device=dev)
