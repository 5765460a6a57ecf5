"""``python -m repro_torch.analysis`` — run every checker, print the
findings, exit 1 when any survive suppression.

The AST rules use the standard library only; the kernel-contract checker
imports ``repro_torch.kernels`` (and so torch) only when the kernel
sources are in scope and ``--no-kernel-checks`` is not given.  By
default it checks the port (``src/repro_torch``) and ``chip_smoke.py``,
not ``repro``'s tree, which ``python -m repro.analysis`` checks.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from pathlib import Path
from typing import Optional

from repro_torch.analysis import jitgeo, tracelint
from repro_torch.analysis.astutil import iter_py_files
from repro_torch.analysis.findings import (
    COUNTERPARTS,
    RULES,
    Finding,
    apply_suppressions,
    scan_suppressions,
)

_PACKAGE = Path(__file__).resolve().parents[1]  # src/repro_torch
_KERNEL_SOURCE = os.path.join("kernels", "dpp_greedy", "tiled.py")


def default_paths() -> list[str]:
    """The port's package and the checkout's ``chip_smoke.py``, relative
    to the working directory where they lie under it."""
    out = []
    for p in (_PACKAGE, _PACKAGE.parents[1] / "chip_smoke.py"):
        if p.exists():
            rel = os.path.relpath(p)
            out.append(p.as_posix() if rel.startswith("..") else rel)
    return out


def run_analysis(
    paths: list[str], kernel_checks: bool = True, capacities=None,
) -> tuple[list[Finding], dict]:
    """Run all checkers over ``paths``; the kernel contracts with
    ``capacities`` (``kernels.Capacities``; default the H100 model).
    Returns (findings after suppression, summary dict)."""
    files = list(iter_py_files(paths))
    findings: list[Finding] = []
    suppressions: dict[str, dict[int, set[str]]] = {}
    trees: dict[str, ast.Module] = {}
    skipped: list[str] = []
    for path in files:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        supp, bad = scan_suppressions(path, text)
        suppressions[path] = supp
        findings.extend(bad)
        try:
            trees[path] = ast.parse(text, filename=path)
        except SyntaxError:
            skipped.append(path)
    # memoised plan functions anywhere in the run key call sites in all
    memo = set()
    for tree in trees.values():
        memo |= set(jitgeo.memo_functions(tree))

    routers: list[dict] = []
    sessions: list[dict] = []
    for path, tree in trees.items():
        findings.extend(tracelint.check_module(path, tree))
        findings.extend(jitgeo.check_module(path, tree, memo))
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for summarize, out in (
                        (jitgeo.router_geometry_summary, routers),
                        (jitgeo.session_geometry_summary, sessions)):
                    summary = summarize(node)
                    if summary is not None:
                        summary["path"] = path
                        out.append(summary)

    kernel_summary: Optional[dict] = None
    autotune_summary: Optional[dict] = None
    if kernel_checks and any(p.endswith(_KERNEL_SOURCE) for p in files):
        from repro_torch.analysis.kernels import (
            check_autotune_cache,
            check_kernel_contracts,
        )

        kernel_findings, kernel_summary = check_kernel_contracts(capacities)
        findings.extend(kernel_findings)
        # the persisted autotune cache ($DPP_AUTOTUNE_CACHE or the
        # per-user default) is part of the dispatch surface
        cache_findings, autotune_summary = check_autotune_cache(
            capacities=capacities)
        findings.extend(cache_findings)

    findings = sorted(set(apply_suppressions(findings, suppressions)))
    summary = {
        "files": len(files),
        "skipped_syntax": skipped,
        "router_geometry": routers,
        "session_geometry": sessions,
        "kernel_contracts": kernel_summary,
        "autotune_cache": autotune_summary,
        "findings": len(findings),
    }
    return findings, summary


def summary_line(findings: list[Finding], summary: dict) -> str:
    """The one-line tail the CLI prints after the findings."""
    tail = f"{summary['files']} files checked, {len(findings)} finding(s)"
    kc = summary["kernel_contracts"]
    if kc:
        tail += (f"; kernel contracts: {kc['geometries']} geometries "
                 f"across {len(kc['families'])} families "
                 f"({kc['capacities']})")
    ac = summary.get("autotune_cache")
    if ac and ac.get("present"):
        tail += (f"; autotune cache: {ac['checked']}/{ac['entries']} "
                 f"entries validated ({ac['path']})")
    for geo in summary["router_geometry"]:
        if geo.get("reachable_geometries") == 1:
            tail += (f"; {geo['class']}: 1 reachable launch geometry "
                     f"({geo['launch_sites']} launch site)")
    for geo in summary["session_geometry"]:
        if geo.get("reachable_geometries") == 1:
            fams = sum(1 for n in geo["launch_sites"].values() if n)
            tail += (f"; {geo['class']}: 1 reachable launch geometry per "
                     f"(shape, chunk) ({fams} launch families)")
    return tail


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static checks of the port: CUDA launch contracts, "
                    "launch geometry, host-path lint.",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to check (default: src/repro_torch and "
             "chip_smoke.py)",
    )
    parser.add_argument(
        "--error-on-findings", action="store_true",
        help="exit 1 when findings survive suppression (the default "
             "behaviour; the flag lets a caller state its gate)",
    )
    parser.add_argument(
        "--no-kernel-checks", action="store_true",
        help="skip the CUDA launch-contract checker (AST rules only)",
    )
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--verbose", action="store_true",
                        help="print the geometry and contract summaries")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            stands = COUNTERPARTS.get(rule) or "no repro counterpart"
            print(f"{rule}: {RULES[rule]} [repro: {stands}]")
        return 0

    paths = args.paths or default_paths()
    if not paths:
        print("no paths to check", file=sys.stderr)
        return 2
    findings, summary = run_analysis(
        paths, kernel_checks=not args.no_kernel_checks)

    if args.json:
        print(json.dumps({
            "findings": [dataclass_dict(f) for f in findings],
            "summary": summary,
        }, indent=2, default=str))
    else:
        for f in findings:
            print(f.format())
        print(summary_line(findings, summary))
        if args.verbose:
            print(json.dumps(summary, indent=2, default=str))
    return 1 if findings else 0


def dataclass_dict(f: Finding) -> dict:
    return {"path": f.path, "line": f.line, "rule": f.rule,
            "message": f.message}


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
