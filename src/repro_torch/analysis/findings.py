"""Findings and suppression framework for ``repro_torch.analysis``.

Every checker reports :class:`Finding` records: a rule id from
:data:`RULES`, a ``path:line`` anchor and a message.  A finding is
suppressed by putting ``# repro_torch: ignore[rule-id]`` on the anchored
line, with the reason beside it; a suppression naming an unknown rule id
is itself a finding (``bad-suppression``), so a typo cannot silently
disable a check.

The marker is the port's own: ``repro``'s checker reads every
``# repro: ignore[...]`` comment under ``src/`` (this package included)
and would report the port's rule ids as unknown.

Each rule of the catalog stands for one of ``repro.analysis``' rules
(:data:`COUNTERPARTS`), or for none where the hazard is the card's own.
"""
from __future__ import annotations

import dataclasses
import io
import os
import re
import tokenize
from typing import Optional

# rule id -> one-line description (the catalog --list-rules prints)
RULES: dict[str, str] = {
    # -- host and capture lint (tracelint.py) ----------------------------
    "capture-sync": (
        ".item()/.cpu()/.tolist()/.numpy(), or float()/int()/bool() on a "
        "tensor, in code captured into a CUDA graph (the capture raises: "
        "a host read cannot be recorded)"
    ),
    "capture-pyif": (
        "Python `if`/`while` on a tensor in code captured into a CUDA "
        "graph (the capture raises, or freezes one branch into the graph)"
    ),
    "host-sync-hot": (
        "host sync (.item/.cpu/.tolist/.numpy, np.asarray/np.array, "
        "torch.cuda.synchronize or an event's/stream's .synchronize) in a "
        "router pump() outside the designated *.sync/*.materialize spans"
    ),
    "obs-nonstatic": (
        "device work (a torch. call, a tensor method, .item) inside an "
        "obs.span(...) call site: hook arguments must be host scalars"
    ),
    "dead-shim": (
        "import or attribute use of a serving name the port does not "
        "offer at repro_torch.serving (rerank/rerank_batch/rerank_stream/"
        "sharded_rerank_stream): use Reranker/RerankRequest"
    ),
    # -- launch geometry (jitgeo.py) -------------------------------------
    "plan-key-tensor": (
        "a tensor as a key of an lru_cache-memoised launch-plan function "
        "(argument or annotated parameter): a tensor hashes by identity, "
        "so every request re-plans and the cache pins its tensor"
    ),
    "plan-key-unhashable": (
        "an unhashable literal (list/dict/set) passed to an lru_cache-"
        "memoised launch-plan function: the call raises TypeError"
    ),
    "router-geometry": (
        "router launch-geometry attribute written outside __init__ (or "
        "outside its lazy `is None` guard), or more than one slot-chunk "
        "launcher or launch site: the one-geometry proof fails"
    ),
    "session-geometry": (
        "session launch-geometry attribute written outside __init__, or "
        "more than one launch site for a resume/extend/rescore family or "
        "the delta solve: a resumed session could reach geometries "
        "beyond (shape, chunk)"
    ),
    # -- CUDA launch contracts (kernels.py) ------------------------------
    "cuda-coverage": (
        "a launch plan whose tiles, cluster CTAs or K7 CTAs do not cover "
        "every candidate column (row) exactly once"
    ),
    "cuda-alignment": (
        "a tile that is not a multiple of the 32-thread warp (nor the "
        "whole M), a cluster slice not 16-byte aligned, or K7 block rows "
        "not a multiple of 128"
    ),
    "cuda-smem-budget": (
        "a plan whose dynamic shared memory a block (a cluster CTA) "
        "exceeds the 232,448 B Hopper budget"
    ),
    "cuda-smem-model": (
        "the bytes a kernel wrapper hands over for its launch differ "
        "from the tiling model's bytes for that plan"
    ),
    "cuda-cluster": (
        "a cluster size outside CLUSTER_SIZES (at most 8, portable), a "
        "size of 16 without the non-portable attribute, or a cluster the "
        "card cannot place"
    ),
    "cuda-coresidency": (
        "a cooperative launch (K5, K6, K7) with more blocks than the card "
        "keeps co-resident (SMs x blocks an SM at the plan's shared "
        "memory): the launch is refused or deadlocks at its barrier"
    ),
    "autotune-cache-invalid": (
        "a persisted autotune cache entry that could ship a launch the "
        "rules above refuse (autotune.tile_fits: not a warp multiple, "
        "over the shared-memory budget, a cooperative grid past the "
        "capacity), a key that does not reproduce from its fields, or an "
        "unreadable/foreign-schema cache file"
    ),
    # -- framework -------------------------------------------------------
    "bad-suppression": (
        "`# repro_torch: ignore[...]` naming an unknown rule id (a typo "
        "would silently disable nothing, and hide that it does)"
    ),
}

# rule id -> the repro.analysis rule it stands for (None: a hazard of the
# card with no TPU counterpart)
COUNTERPARTS: dict[str, Optional[str]] = {
    "capture-sync": "trace-cast",
    "capture-pyif": "trace-pyif",
    "host-sync-hot": "host-sync-hot",
    "obs-nonstatic": "obs-nonstatic",
    "dead-shim": "dead-shim",
    "plan-key-tensor": "jit-static-missing",
    "plan-key-unhashable": "jit-static-unhashable",
    "router-geometry": "router-geometry",
    "session-geometry": "session-geometry",
    "cuda-coverage": "pallas-coverage-gap",
    "cuda-alignment": "pallas-block-divisibility",
    "cuda-smem-budget": "pallas-vmem-budget",
    "cuda-smem-model": "pallas-vmem-model",
    "cuda-cluster": None,
    # a CUDA block keeps no output block across grid steps, so the Mosaic
    # revisit hazard has no counterpart; a cooperative grid larger than
    # what stays co-resident takes its place
    "cuda-coresidency": "pallas-revisit-gap",
    "autotune-cache-invalid": "autotune-cache-invalid",
    "bad-suppression": "bad-suppression",
}

_SUPPRESS_RE = re.compile(r"#\s*repro_torch:\s*ignore\[([^\]]*)\]")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One checker hit, anchored to ``path:line``."""

    path: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def scan_suppressions(
    path: str, text: str
) -> tuple[dict[int, set[str]], list[Finding]]:
    """Parse ``# repro_torch: ignore[rule-id]`` comments.

    Returns ``(suppressions, findings)``: ``suppressions`` maps a
    1-indexed line to the rule ids suppressed there, ``findings`` holds a
    ``bad-suppression`` per unknown rule id.  Only real comment tokens
    count: the pattern in a docstring or string literal is prose."""
    supp: dict[int, set[str]] = {}
    findings: list[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return supp, findings
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        lineno = tok.start[0]
        for m in _SUPPRESS_RE.finditer(tok.string):
            for rule in (r.strip() for r in m.group(1).split(",")):
                if not rule:
                    continue
                if rule not in RULES:
                    findings.append(Finding(
                        path, lineno, "bad-suppression",
                        f"unknown rule id {rule!r} in suppression "
                        f"(known: {', '.join(sorted(RULES))})",
                    ))
                    continue
                supp.setdefault(lineno, set()).add(rule)
    return supp, findings


def apply_suppressions(
    findings: list[Finding], suppressions: dict[str, dict[int, set[str]]]
) -> list[Finding]:
    """Drop findings whose anchored line suppresses their rule
    (``suppressions``: path -> line -> rule ids, per file from
    :func:`scan_suppressions`; a finding's path and a suppression's may
    name one file differently).  ``bad-suppression`` cannot be
    suppressed."""
    by_file = {os.path.realpath(p): lines
               for p, lines in suppressions.items()}
    kept = []
    for f in findings:
        if f.rule != "bad-suppression" and f.rule in by_file.get(
                os.path.realpath(f.path), {}).get(f.line, ()):
            continue
        kept.append(f)
    return kept
