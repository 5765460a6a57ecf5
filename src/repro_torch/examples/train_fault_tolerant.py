"""Fault-tolerant training demo (the torch counterpart of ``repro``'s
``examples/train_fault_tolerant.py``): train a reduced DeepFM for 120
steps with async checkpointing, inject a failure at step 80, then
auto-resume and finish - the restart path a production fleet exercises
on every node failure.

  PYTHONPATH=src python -m repro_torch.examples.train_fault_tolerant \
      [--device cpu]

Each run is ``python -m repro_torch.launch.train`` in a subprocess.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ,
               PYTHONPATH=SRC if not path else os.pathsep.join([SRC, path]))
    with tempfile.TemporaryDirectory() as ckpt:
        base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "deepfm", "--reduced", "--steps", "120", "--batch", "128",
                "--ckpt-dir", ckpt, "--ckpt-every", "25", "--log-every",
                "25", "--device", args.device]
        print("== run 1: fails at step 80 (injected) ==", flush=True)
        r1 = subprocess.run(base + ["--fail-at-step", "80"], env=env)
        if r1.returncode == 0:
            raise SystemExit("expected the injected failure")
        print("\n== run 2: --resume auto continues from the last commit ==",
              flush=True)
        r2 = subprocess.run(base + ["--resume", "auto"], env=env)
        if r2.returncode != 0:
            raise SystemExit(f"the resumed run failed ({r2.returncode})")
    print("\nrestart test passed: training resumed and completed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
