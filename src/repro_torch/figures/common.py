"""What the figure scripts share: the device line, timing and the CLI."""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (
    build_kernel_dense_raw,
    normalize_columns,
    scaled_features_raw,
    similarity_from_features,
)
from repro_torch.device import resolve_device


def paper_setup(M=1000, D=100, seed=0, device=None):
    """The paper's §5.1 synthetic setup (Figures 1 and 2), from
    ``repro``'s draws: uniform relevance ``r (M,)``, uniform
    column-normalised features ``F (D, M)``, ``S = F^T F``.  Returns
    ``(r, S, L = Diag(r) S Diag(r), V = F Diag(r))`` float32 on the
    device, with ``L = V^T V``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    r = torch.as_tensor(rng.uniform(size=M), dtype=torch.float32, device=dev)
    F = normalize_columns(torch.as_tensor(rng.uniform(size=(D, M)),
                                          dtype=torch.float32, device=dev))
    S = similarity_from_features(F)
    return r, S, build_kernel_dense_raw(r, S), scaled_features_raw(F, r)


def device_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; ``"cpu"`` on the
    CPU.  On a card a failed query raises: no time is printed without
    the power limit beside it."""
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_line(device: torch.device) -> str:
    """The comment line every figure prints above its CSV rows."""
    if device.type == "cuda":
        return f"# device: {device_name(device)}"
    return ("# device: cpu (the kernel rows run the kernels' plain PyTorch "
            "versions; no time here is a device time)")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn: Callable[[], object], device: torch.device) -> float:
    """Seconds of one ``fn()`` between two synchronizations of the
    device: the whole call, its device work included."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def mean_time(fn, trials: int, device: torch.device) -> float:
    """Mean of ``trials`` walls after one warm call."""
    fn()
    return statistics.fmean(wall(fn, device) for _ in range(trials))


def best_time(fn, trials: int, device: torch.device) -> float:
    """Least of ``trials`` walls after one warm call."""
    fn()
    return min(wall(fn, device) for _ in range(trials))


def launch_delta(before: dict, after: dict) -> dict:
    """The kernels' launches between two ``cuda.launch_counts()`` reads
    (the counters are read, never reset, so a caller's count of a longer
    run stays whole)."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def arg_parser(doc: str) -> argparse.ArgumentParser:
    """``[--smoke | --full] [--device cuda|cpu]``, described by the first
    paragraph of ``doc``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--full", action="store_true",
                      help="the paper's sweep sizes")
    size.add_argument("--smoke", action="store_true",
                      help="the fast sizes (the default)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def parse(doc: str, argv: Optional[Sequence[str]] = None):
    """A figure's command line -> (fast_mode, device).  Fast (the
    ``--smoke`` sizes) unless ``--full``; the card unless ``--device
    cpu``."""
    args = arg_parser(doc).parse_args(argv)
    return not args.full, resolve_device(args.device)
