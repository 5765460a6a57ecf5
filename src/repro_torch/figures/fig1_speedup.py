"""Paper Figure 1: running time of the original (determinant-based)
greedy MAP vs the proposed Div-DPP acceleration, N = 5..50 step 5,
M = 1000, D = 100 synthetic (paper §5.1 setup exactly); the counterpart
of ``repro``'s ``benchmarks/fig1_speedup.py``.

Four slates per N, all on the same kernel ``L = Diag(r) S Diag(r)``:

* ``naive``: the numpy float64 determinant greedy, ``repro``'s own
  baseline (``greedy_map_naive``, one ``numpy.linalg.det`` per candidate
  and step); the reference every other slate is compared with;
* ``naive_slogdet``: the same greedy vectorized on the device, one batched
  ``torch.linalg.slogdet`` per step (``greedy_map_naive_vmapped``) on the
  float64 L, so it is also a float64 reference where the numpy greedy
  is not run;
* ``divdpp``: Algorithm 1, the torch core ``dpp_greedy_dense`` (float32);
* ``divdpp_kernel``: Algorithm 1 on the low-rank ``V = F Diag(r)``
  through ``greedy_map(GreedySpec(k=N, backend="kernel"))``: K1 on the
  card, its plain version on the CPU.

``exact_match`` compares a fast slate with the float64 one index for
index (``repro`` reports it and gates nothing; ``chip_smoke.py``
certifies any difference as a float64 near-tie).

  python -m repro_torch.figures.fig1_speedup [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (
    GreedySpec,
    dpp_greedy_dense,
    greedy_map,
    greedy_map_naive,
)
from repro_torch.core.greedy_naive import greedy_map_naive_vmapped
from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    device_line,
    mean_time,
    paper_setup,
    parse,
)

PAPER_NS = tuple(range(5, 55, 5))
FAST_NS = (5, 10, 20)


def setup(M=1000, D=100, seed=0, device=None):
    """(L float32 (M, M), V float32 (D, M) with L = V^T V, L float64) on
    the device (``common.paper_setup``)."""
    _, _, L, V = paper_setup(M, D, seed, device)
    return L, V, L.double()


def run(trials=3, Ns: Sequence[int] = PAPER_NS,
        numpy_Ns: Optional[Sequence[int]] = None, M=1000, D=100,
        device=None):
    """One dict a N: times in seconds (``t_naive`` None where the numpy
    greedy did not run), slates (k,) int64 numpy, and ``exact_match`` of
    each fast slate against the float64 reference (the numpy slate where
    it ran, else the device's float64 slogdet slate; the slogdet slate's
    own match is None there).  ``numpy_Ns``
    (default: every N) are the N at which the numpy greedy runs."""
    dev = resolve_device(device)
    numpy_Ns = tuple(Ns) if numpy_Ns is None else tuple(numpy_Ns)
    L, V, L64 = setup(M, D, device=dev)
    L64_np = L64.cpu().numpy()
    rows = []
    for N in Ns:
        spec = GreedySpec(k=N, backend="kernel")
        slates = {}

        def core():
            slates["divdpp"] = dpp_greedy_dense(L, N).indices

        def kernel():
            slates["divdpp_kernel"] = greedy_map(spec, V=V).indices

        def slogdet():
            slates["naive_slogdet"] = greedy_map_naive_vmapped(L64, N)

        t_core = mean_time(core, trials, dev)
        t_kernel = mean_time(kernel, trials, dev)
        t_slogdet = mean_time(slogdet, trials, dev)
        t_naive = None
        if N in numpy_Ns:
            # original: determinant per candidate per step (numpy float64,
            # the paper's numpy.linalg.det baseline), one run as in repro
            t0 = time.perf_counter()
            slates["naive"] = greedy_map_naive(L64_np, N)[0]
            t_naive = time.perf_counter() - t0
        slates = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v,
                                np.int64) for k, v in slates.items()}
        ref = slates.get("naive", slates["naive_slogdet"])
        same = {k: bool(np.array_equal(slates[k], ref))
                for k in ("naive_slogdet", "divdpp", "divdpp_kernel")}
        if "naive" not in slates:
            same["naive_slogdet"] = None  # it is the reference
        rows.append(dict(
            N=N, t_naive=t_naive, t_slogdet=t_slogdet, t_core=t_core,
            t_kernel=t_kernel, slates=slates, exact_match=same,
        ))
    return rows


def _speedups(t, row):
    out = [f"speedup_vs_slogdet={row['t_slogdet'] / max(t, 1e-12):.1f}x"]
    if row["t_naive"] is not None:
        out.insert(0, f"speedup={row['t_naive'] / max(t, 1e-12):.1f}x")
    return ";".join(out)


def main(fast_mode=False, device=None, numpy_Ns=None):
    dev = resolve_device(device)
    trials = 2 if fast_mode else 3
    Ns = FAST_NS if fast_mode else PAPER_NS
    rows = run(trials=trials, Ns=Ns, numpy_Ns=numpy_Ns, device=dev)
    print(device_line(dev))
    print("name,us_per_call,derived")
    for row in rows:
        N, same = row["N"], row["exact_match"]
        if row["t_naive"] is not None:
            print(f"fig1_naive_N{N},{row['t_naive'] * 1e6:.1f},"
                  f"exact_match={same['divdpp'] and same['divdpp_kernel']}")
        print(f"fig1_naive_slogdet_N{N},{row['t_slogdet'] * 1e6:.1f},"
              f"float64;exact_match={same['naive_slogdet']}")
        print(f"fig1_divdpp_N{N},{row['t_core'] * 1e6:.1f},"
              f"{_speedups(row['t_core'], row)};"
              f"exact_match={same['divdpp']}")
        print(f"fig1_divdpp_kernel_N{N},{row['t_kernel'] * 1e6:.1f},"
              f"{_speedups(row['t_kernel'], row)};"
              f"exact_match={same['divdpp_kernel']}")
    return rows


if __name__ == "__main__":
    fast, dev = parse(__doc__)
    main(fast_mode=fast, device=dev)
