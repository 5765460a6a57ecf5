"""Run every (arch x shape x mesh x profile) dry-run cell, each in a
subprocess of its own (one fake world a process), skipping completed
cells (the torch counterpart of ``repro.launch.run_dryruns``).

  PYTHONPATH=src python -m repro_torch.launch.run_dryruns [--mesh pod multipod]
      [--only arch1,arch2] [--timeout 3600] [--force] [--device cpu]

Besides ``baseline`` every LM cell runs under ``fsdp_ep`` and every
recsys cell under ``a2a_emb``, the training cells as the serving ones.
A cell that fails records ``status: "error"`` and its exception, as
``repro``'s do, and the run ends nonzero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.launch.dryrun import record_path

FAMILY_PROFILES = {"lm": ("fsdp_ep",), "recsys": ("a2a_emb",), "gnn": ()}


def cell_record(out_dir, arch, shape, mesh, profile):
    try:
        with open(record_path(out_dir, arch, shape, mesh, profile)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def cell_done(out_dir, arch, shape, mesh, profile="baseline") -> bool:
    """Recorded ``ok`` or ``skipped``."""
    rec = cell_record(out_dir, arch, shape, mesh, profile)
    return rec is not None and rec.get("status") in ("ok", "skipped")


def cells(archs, meshes):
    from repro_torch.configs import get_arch

    out = []
    for a in archs:
        spec = get_arch(a)
        for s in spec.shapes:
            for m in meshes:
                for p in ("baseline",) + FAMILY_PROFILES[spec.family]:
                    out.append((a, s, m, p))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", nargs="+", default=["pod", "multipod"])
    ap.add_argument("--only", default="")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import list_archs

    archs = args.only.split(",") if args.only else list_archs()
    todo = cells(archs, args.mesh)
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    print(f"{len(todo)} cells")
    failures = []
    for i, (a, s, m, p) in enumerate(todo):
        tag = f"[{i + 1}/{len(todo)}] {a} {s} {m} {p}"
        if not args.force and cell_done(args.out, a, s, m, p):
            print(f"{tag}: cached")
            continue
        t0 = time.time()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               a, "--shape", s, "--mesh", m, "--out", args.out, "--profile",
               p, "--device", args.device]
        tail = ""
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout, env=env,
                               stdin=subprocess.DEVNULL)
            tail = (r.stderr or "")[-800:]
        except subprocess.TimeoutExpired:
            os.makedirs(args.out, exist_ok=True)
            with open(record_path(args.out, a, s, m, p), "w") as f:
                json.dump({"arch": a, "shape": s, "mesh": m, "profile": p,
                           "status": "timeout", "timeout_s": args.timeout},
                          f)
        rec = cell_record(args.out, a, s, m, p)
        status = rec.get("status", "?") if rec else "no record"
        if status not in ("ok", "skipped"):
            failures.append((a, s, m, p))
        print(f"{tag}: {status} ({time.time() - t0:.0f}s)")
        if status not in ("ok", "skipped") and tail:
            print("  stderr tail:", tail.replace("\n", "\n  "))
    print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
