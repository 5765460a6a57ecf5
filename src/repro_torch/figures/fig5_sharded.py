"""Sharded candidate-axis greedy MAP: weak-scaling sweep (beyond-paper);
the counterpart of ``repro``'s ``benchmarks/fig5_sharded.py``.

Fixes the per-rank shard ``Mloc`` and grows the candidate set
``M = Mloc * P`` with the rank count P.  The claim under test is the
sharded step's structure: O(w M / P) local work plus one small
all-gather (the cross-shard argmax) and one all-reduce (the winner's
columns), so ``us_per_user_step`` stays roughly flat as M grows with
``Mloc`` fixed.  Each (mode, P) also gets a B > 1 row: a user batch
sharing the group (state ``(B, Mloc)`` a rank, collectives batched over
B), whose per-user cost should sit well below B times the single
slate's.

Each P runs its ranks as subprocesses through
``repro_torch.distributed.spawn_ranks`` (never ``fork``, a file
rendezvous, a time limit, every rank ended when one fails): NCCL when
the host has P cards, otherwise gloo ranks sharing the card (or the
CPU); each row names its backend.  On one card the rows show how a
sharded step is built, not a gain from more cards, as ``repro``'s rows
on a host-device mesh show the structure and not the multi-chip win.

The port's sharded path always runs the shard-local update entry of
K3/K4 (on the CPU its plain version).  So the counterpart of ``repro``'s
``tile=None`` row (its jnp step) is the default tile,
``tiling.DEFAULT_TILE_M``, printed as that ``tile_m``; the ``_tm<tile>``
row is the preset's tile.  ``past_gate=1`` marks shards whose gains no
longer fit the resident kernels' shared-memory budget
(``tiling.resident_smem_bytes`` past ``SMEM_BUDGET_BYTES``), the regime
where a single card would run the tiled kernels too.  Times are a
rank's least wall of ``trials`` calls after a warm call, each between
two synchronisations, the slowest rank's per row.

  python -m repro_torch.figures.fig5_sharded [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.figures.common import best_time, device_line, parse

EPS = 1e-6
TIMEOUT_S = 1200
PRESETS = {
    # fast: tiny shapes, 1 and 2 ranks
    True: dict(devices=(1, 2), mloc=2048, dim=24, slate=8, window=4,
               trials=2, batch=4, tile_m=512),
    # full: Mloc = 65,536 puts a shard's gains past the resident
    # kernels' shared memory (past_gate=1 rows)
    False: dict(devices=(1, 2, 4, 8), mloc=65536, dim=32, slate=32,
                window=8, trials=3, batch=8, tile_m=8192),
}


def _rank(args) -> None:
    """One rank of a P-rank group: time every row's call and print one
    JSON line with the rows and this rank's update launches."""
    from repro_torch.core import dpp_greedy_sharded
    from repro_torch.distributed import init_group, leave_group, make_mesh
    from repro_torch.kernels import cuda
    from repro_torch.kernels.dpp_greedy.tiling import (
        DEFAULT_TILE_M,
        SMEM_BUDGET_BYTES,
        resident_smem_bytes,
    )

    cfg = PRESETS[args.preset == "smoke"]
    dev = (torch.device("cpu") if args.device == "cpu" else
           torch.device("cuda", args.rank % torch.cuda.device_count()))
    init_group(args.backend, args.rank, args.world, args.init_file,
               TIMEOUT_S, dev)
    mesh = make_mesh(device=dev)
    P, mloc, dim, slate = mesh.size, cfg["mloc"], cfg["dim"], cfg["slate"]
    M = mloc * P
    rng = np.random.default_rng(0)  # repro's draw
    Vb = torch.as_tensor(rng.normal(size=(cfg["batch"], dim, M)),
                         dtype=torch.float32) / np.sqrt(dim)
    cuda.reset_launch_counts()
    rows = []
    for label, window in (("exact", None), (f"w{cfg['window']}",
                                            cfg["window"])):
        rows_state = slate if window is None else min(window, slate)
        past = int(resident_smem_bytes(dim, mloc, rows_state,
                                       window is not None)
                   > SMEM_BUDGET_BYTES)
        for tile in (None, cfg["tile_m"]):
            for B in sorted({1, cfg["batch"]}):
                V = Vb[0] if B == 1 else Vb[:B]

                def call():
                    dpp_greedy_sharded(V, slate, mesh=mesh, window=window,
                                       eps=EPS, tile_m=tile)

                best = best_time(call, cfg["trials"], dev)
                tl = "" if tile is None else f"_tm{tile}"
                rows.append(dict(
                    name=f"fig5_sharded_{label}{tl}_B{B}_P{P}_M{M}",
                    us=best * 1e6, B=B, tile_m=tile or DEFAULT_TILE_M,
                    past_gate=past))
    print(json.dumps({"rows": rows, "launches": cuda.launch_counts()}),
          flush=True)
    leave_group()


def _backend(P: int, device: torch.device) -> str:
    if device.type == "cuda" and torch.cuda.device_count() >= P:
        return "nccl"
    return "gloo"


def _run_p(P: int, preset: str, device: torch.device):
    """P ranks of one group: ``(backend, [each rank's record])``."""
    from repro_torch.distributed import spawn_ranks

    backend = _backend(P, device)
    with tempfile.TemporaryDirectory() as tmp:
        def argv(r):
            return ["-m", "repro_torch.figures.fig5_sharded", "--rank",
                    str(r), "--world", str(P), "--init-file",
                    str(Path(tmp) / "rendezvous"), "--backend", backend,
                    "--preset", preset, "--device", device.type]

        outs = spawn_ranks(argv, P, TIMEOUT_S)
    return backend, [json.loads(o.strip().splitlines()[-1]) for o in outs]


def run(fast_mode: bool, device: torch.device, at_once: bool = False):
    """Every P of the preset: ``(rows, launches, failures)``.  Rows are
    dicts with the CSV row's fields (the slowest rank's time); launches
    ``{P: {kernel: launches summed over the ranks}}``.  ``at_once``
    starts every P's ranks together (their times then share the card)."""
    from repro_torch.distributed import RankError

    cfg = PRESETS[fast_mode]
    preset = "smoke" if fast_mode else "full"
    with concurrent.futures.ThreadPoolExecutor(
            len(cfg["devices"]) if at_once else 1) as pool:
        futures = [(P, pool.submit(_run_p, P, preset, device))
                   for P in cfg["devices"]]
        rows, launches, failures = [], {}, []
        for P, fut in futures:
            try:
                backend, recs = fut.result()
            except RankError as e:
                print(f"fig5_sharded P={P}: {e}", file=sys.stderr,
                      flush=True)
                failures.append((P, str(e).splitlines()[0]))
                continue
            launches[P] = {}
            for rec in recs:
                for k, n in rec["launches"].items():
                    launches[P][k] = launches[P].get(k, 0) + n
            for i, row in enumerate(recs[0]["rows"]):
                us = max(rec["rows"][i]["us"] for rec in recs)
                rows.append(dict(row, us=us, P=P, backend=backend))
    return rows, launches, failures


def main(fast_mode=False, device=None, at_once=False):
    """Print the device line and the CSV rows; return ``{"rows",
    "launches"}``.  Raises when any P's ranks failed."""
    dev = resolve_device(device)
    cfg = PRESETS[fast_mode]
    rows, launches, failures = run(fast_mode, dev, at_once)
    print(device_line(dev))
    print("name,us_per_call,derived")
    for r in rows:
        print(f"{r['name']},{r['us']:.1f},"
              f"us_per_user_step={r['us'] / (cfg['slate'] * r['B']):.2f};"
              f"B={r['B']};Mloc={cfg['mloc']};D={cfg['dim']};"
              f"N={cfg['slate']};tile_m={r['tile_m']};"
              f"past_gate={r['past_gate']};backend={r['backend']}")
    for P, err in failures:
        print(f"fig5_sharded_P{P},0,error={err}")
    if failures:
        raise RuntimeError(f"fig5_sharded rank failures: {failures}")
    return {"rows": rows, "launches": launches}


if __name__ == "__main__":
    if "--rank" in sys.argv[1:]:
        ap = argparse.ArgumentParser()
        for flag in ("--rank", "--world"):
            ap.add_argument(flag, type=int, required=True)
        for flag in ("--init-file", "--backend", "--preset", "--device"):
            ap.add_argument(flag, required=True)
        _rank(ap.parse_args())
    else:
        fast, dev = parse(__doc__)
        main(fast_mode=fast, device=dev)
