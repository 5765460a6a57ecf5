"""Run the port's figures, print their CSV and write one
``BENCH_<fig>.json`` artifact each; the counterpart of ``repro``'s
``benchmarks/run.py`` for Figures 1-10.

  python -m repro_torch.figures.run [--smoke | --full] [--device cuda|cpu] [--out-dir DIR]

Fast mode (the ``--smoke`` sizes) unless ``--full``.  Artifacts go to
``--out-dir`` (default ``figures_out/``, which ``.gitignore`` lists),
never to ``benchmarks/results/``: those are ``repro``'s CPU artifacts,
and this command refuses to write there.  Each artifact holds the parsed
rows, the wall seconds, the gate outcome (``status``/``error``: the
figures raise on red gates), the device (the card's name and power
limit as ``nvidia-smi`` gives them, torch and CUDA versions) and the
snapshot of the port's observability registry over the figure (kernel
dispatch modes, greedy calls and steps).  A figure failing its gates
does not stop the rest; the command exits nonzero at the end if any
failed.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import platform
import sys
import time
from pathlib import Path

import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.figures import (
    fig1_speedup,
    fig2_reference,
    fig3_tradeoff,
    fig4_windowed,
    fig5_sharded,
    fig6_streaming,
    fig7_serving,
    fig8_observability,
    fig9_autotune,
    fig10_session,
)
from repro_torch.figures.common import arg_parser, device_name

DEFAULT_OUT_DIR = "figures_out"
# repro's artifacts, relative to a checkout's root
REPRO_RESULTS = Path("benchmarks") / "results"
FIGURES = (
    ("fig1", "Figure 1: original greedy MAP vs Div-DPP (speedup, "
     "exactness)", fig1_speedup.main),
    ("fig2", "Figure 2: MMR / Greedy / Div-DPP runtime",
     fig2_reference.main),
    ("fig3", "Figure 3: accuracy-diversity trade-off", fig3_tradeoff.main),
    ("fig4", "Figure 4: sliding-window vs exact, N >> w (per-step cost "
     "flat in N)", fig4_windowed.main),
    ("fig5", "Figure 5: sharded candidate axis, weak scaling (Mloc fixed, "
     "M = Mloc * P)", fig5_sharded.main),
    ("fig6", "Figure 6: streaming slate emission, time-to-first-chunk vs "
     "whole", fig6_streaming.main),
    ("fig7", "Figure 7: continuous-batching serving, router vs serial "
     "streaming and an open-loop sweep", fig7_serving.main),
    ("fig8", "Figure 8: observability, the router pump's phases from "
     "spans and the rebuild ledger", fig8_observability.main),
    ("fig9", "Figure 9: measured tile choice (tile_m='auto') vs the "
     "on-chip budget model", fig9_autotune.main),
    ("fig10", "Figure 10: session delta-resume vs a full re-rerank",
     fig10_session.main),
)


def bench_meta(device: torch.device) -> dict:
    """Device and provenance stamp of every artifact."""
    return {
        "device": str(device),
        "device_name": device_name(device),  # name, power limit on a card
        "device_count": (torch.cuda.device_count()
                         if device.type == "cuda" else 0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": platform.python_version(),
    }


def check_out_dir(out_dir) -> Path:
    """``out_dir`` resolved; raises ``ValueError`` for ``repro``'s
    ``benchmarks/results`` (under the working directory or under the
    checkout this package sits in) or anything inside it."""
    out = Path(out_dir).resolve()
    checkout = Path(__file__).resolve().parents[3]
    for root in (Path.cwd(), checkout):
        theirs = (root / REPRO_RESULTS).resolve()
        if out == theirs or theirs in out.parents:
            raise ValueError(
                f"refusing to write into {theirs}: benchmarks/results holds "
                f"repro's artifacts; pass another --out-dir (default "
                f"{DEFAULT_OUT_DIR}/)")
    return out


class _Tee(io.TextIOBase):
    """Mirror writes to the real stdout while keeping a copy to parse."""

    def __init__(self, real):
        self._real = real
        self._buf = io.StringIO()

    def write(self, s):
        self._real.write(s)
        return self._buf.write(s)

    def flush(self):
        self._real.flush()

    def getvalue(self):
        return self._buf.getvalue()


def _parse_rows(text):
    rows = []
    for line in text.splitlines():
        if line.startswith("#") or line.startswith("name,"):
            continue
        parts = line.split(",", 2)
        if len(parts) != 3:
            continue
        try:
            us = float(parts[1])
        except ValueError:
            continue
        rows.append({"name": parts[0], "us_per_call": us, "derived": parts[2]})
    return rows


def run_fig(fig, title, fn, fast, out_dir, device) -> bool:
    """Run one figure's ``main``, tee its CSV, and write
    ``BENCH_<fig>.json`` into ``out_dir``.  Returns True when the
    figure's gates passed."""
    out_dir = check_out_dir(out_dir)
    print(f"# {title}", flush=True)
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    status, error = "ok", None
    with obs.session(obs.ObsConfig(enabled=True)):
        try:
            with contextlib.redirect_stdout(tee):
                fn(fast_mode=fast, device=device)
        except Exception as e:  # a red gate: recorded, the rest still run
            status, error = "failed", f"{type(e).__name__}: {e}"
            print(f"{fig}_gate,0,status=FAILED;{error}", flush=True)
        reg = obs.registry()
        snapshot = None if reg is None else reg.snapshot()
    doc = {
        "figure": fig,
        "status": status,
        "error": error,
        "fast_mode": fast,
        "elapsed_s": round(time.perf_counter() - t0, 3),
        "meta": bench_meta(device),
        "rows": _parse_rows(tee.getvalue()),
        "obs": snapshot,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(out_dir / f"BENCH_{fig}.json", "w") as f:
        json.dump(doc, f, indent=1, default=str)
    return status == "ok"


def main(argv=None) -> None:
    ap = arg_parser(__doc__)
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help="where BENCH_<fig>.json artifacts land")
    args = ap.parse_args(argv)
    out_dir = check_out_dir(args.out_dir)
    device = resolve_device(args.device)
    failed = [fig for fig, title, fn in FIGURES
              if not run_fig(fig, title, fn, not args.full, out_dir, device)]
    if failed:
        raise SystemExit(f"figures with failed gates: {failed}")


if __name__ == "__main__":
    main()
