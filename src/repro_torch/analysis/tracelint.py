"""AST lint of the port's host paths (rules capture-sync, capture-pyif,
host-sync-hot, obs-nonstatic, dead-shim).

* **host-sync-hot** keeps ``repro``'s scope: the statements of a router
  ``pump()`` itself, scanned flat (not the methods it calls), outside
  the ``*.sync`` / ``*.materialize`` spans whose purpose is to wait.
  ``float()``/``int()``/``bool()`` are left out: the AST cannot tell a
  tensor from the numpy copy the ``.sync`` span took.
* **capture-sync / capture-pyif** scan code captured into a CUDA graph:
  the statements between ``<graph>.capture_begin(...)`` and
  ``capture_end()``, or in a ``with torch.cuda.graph(...)`` body, and
  the body of each ``self.`` method called there, one level deep.
* **obs-nonstatic** flags device work in the arguments of an
  ``obs.span(...)`` call, which run even while tracing is off.
* **dead-shim** flags the serving names ``repro`` removed that the port
  never offered at ``repro_torch.serving``.  ``sharded_rerank`` is not
  one of them: ``repro_torch.serving.sharded_rerank.sharded_rerank`` is
  the mesh backend the ``Reranker`` calls.
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.astutil import (
    TensorNames,
    dotted_name,
    makes_tensor,
)
from repro_torch.analysis.findings import Finding

# serving names repro removed (its PR-6 shims) that the port never had
REMOVED_NAMES = frozenset({
    "rerank", "rerank_batch", "rerank_stream", "sharded_rerank_stream",
})
REMOVED_IMPORTS: dict[str, frozenset[str]] = {
    "repro_torch.serving": REMOVED_NAMES,
    "repro_torch.serving.reranker": frozenset({
        "rerank", "rerank_batch", "rerank_stream",
    }),
    "repro_torch.serving.sharded_rerank": frozenset({
        "sharded_rerank_stream",
    }),
}
# attribute form: `import repro_torch.serving as serving; serving.rerank`
_REMOVED_DOTTED = frozenset(
    f"{prefix}.{name}"
    for prefix in ("serving", "repro_torch.serving")
    for name in REMOVED_NAMES
)

_HOST_SYNC_FUNCS = frozenset({
    "np.asarray", "numpy.asarray", "np.array", "numpy.array",
    "torch.cuda.synchronize",
})
# .synchronize() covers torch.cuda.synchronize, events and streams
_HOST_SYNC_ATTRS = frozenset({"item", "cpu", "tolist", "numpy",
                              "synchronize"})
# pump phases that exist to pay the sync cost, by span-name suffix
_SYNC_SPAN_SUFFIXES = (".sync", ".materialize")

# reads of a tensor to the host: each raises inside a CUDA graph capture
_CAPTURE_READS = frozenset({"item", "cpu", "tolist", "numpy"})
# tensor methods that are device work inside obs.span(...) arguments
_TENSOR_METHODS = frozenset({
    "item", "cpu", "tolist", "numpy", "cuda", "to", "sum", "mean", "max",
    "min", "norm", "any", "all", "argmax", "argmin", "nonzero",
    "count_nonzero", "clone", "contiguous", "float", "double", "abs",
})


def check_module(path: str, tree: ast.Module) -> list[Finding]:
    findings: list[Finding] = []
    _check_dead_shims(path, tree, findings)
    _check_obs_callsites(path, tree, findings)
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == "pump"):
            _check_pump_syncs(path, node, findings)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            _check_captures(path, node, findings)
    # captures in module-level functions (no self methods to follow)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _check_captures_in(path, node, {}, findings)
    return findings


# --------------------------------------------------------------------------
# capture-sync / capture-pyif
# --------------------------------------------------------------------------


def _calls_attr(node: ast.AST, attr: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == attr for n in ast.walk(node))


def _is_graph_ctx(item: ast.withitem) -> bool:
    ctx = item.context_expr
    return (isinstance(ctx, ast.Call)
            and (dotted_name(ctx.func) or "").endswith("cuda.graph"))


def _captured_blocks(fn: ast.FunctionDef) -> list[list[ast.stmt]]:
    """The statement lists ``fn`` captures into a CUDA graph."""
    blocks: list[list[ast.stmt]] = []

    def visit(stmts: list[ast.stmt]) -> None:
        capturing: Optional[list[ast.stmt]] = None
        for st in stmts:
            if capturing is not None:
                if _calls_attr(st, "capture_end"):
                    if isinstance(st, ast.Try):  # try: ... finally: end()
                        capturing.extend(st.body)
                    blocks.append(capturing)
                    capturing = None
                else:
                    capturing.append(st)
                continue
            if (isinstance(st, ast.Expr)
                    and _calls_attr(st, "capture_begin")):
                capturing = []
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                if any(_is_graph_ctx(item) for item in st.items):
                    blocks.append(st.body)
                    continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if isinstance(sub, list) and not isinstance(
                        st, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
                    visit(sub)
            for handler in getattr(st, "handlers", ()):
                visit(handler.body)
        if capturing is not None:  # no capture_end: the rest is captured
            blocks.append(capturing)

    visit(fn.body)
    return blocks


def _check_captures(path: str, cls: ast.ClassDef,
                    findings: list[Finding]) -> None:
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for fn in methods.values():
        _check_captures_in(path, fn, methods, findings)


def _check_captures_in(path: str, fn: ast.FunctionDef, methods: dict,
                       findings: list[Finding]) -> None:
    for block in _captured_blocks(fn):
        where = f"captured in {fn.name!r}"
        followed = set()
        _scan_captured(path, block, TensorNames(), where, findings)
        for st in block:
            for call in ast.walk(st):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and isinstance(call.func.value, ast.Name)
                        and call.func.value.id == "self"):
                    continue
                callee = methods.get(call.func.attr)
                if callee is None or callee.name in followed:
                    continue
                followed.add(callee.name)
                _scan_captured(
                    path, callee.body, TensorNames(),
                    f"{callee.name!r}, called from the capture in "
                    f"{fn.name!r}", findings)


def _scan_captured(path: str, stmts: list[ast.stmt], tn: TensorNames,
                   where: str, findings: list[Finding]) -> None:
    def check_reads(node: ast.AST) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            callee = dotted_name(sub.func)
            if (callee in ("float", "int", "bool") and len(sub.args) == 1
                    and not sub.keywords and tn.is_tensor(sub.args[0])):
                findings.append(Finding(
                    path, sub.lineno, "capture-sync",
                    f"{callee}() on a tensor {where}: a host read cannot "
                    f"be captured into a CUDA graph",
                ))
            elif (isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _CAPTURE_READS and not sub.args):
                findings.append(Finding(
                    path, sub.lineno, "capture-sync",
                    f".{sub.func.attr}() {where}: a host read cannot be "
                    f"captured into a CUDA graph",
                ))

    for st in stmts:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue
        if isinstance(st, (ast.If, ast.While)):
            check_reads(st.test)
            if tn.is_tensor(st.test):
                kind = "if" if isinstance(st, ast.If) else "while"
                findings.append(Finding(
                    path, st.lineno, "capture-pyif",
                    f"Python `{kind}` on a tensor {where}: the capture "
                    f"raises or freezes one branch (use torch.where)",
                ))
            _scan_captured(path, st.body, tn, where, findings)
            _scan_captured(path, st.orelse, tn, where, findings)
        elif isinstance(st, ast.For):
            check_reads(st.iter)
            _scan_captured(path, st.body, tn, where, findings)
            _scan_captured(path, st.orelse, tn, where, findings)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                check_reads(item.context_expr)
            _scan_captured(path, st.body, tn, where, findings)
        elif isinstance(st, ast.Try):
            for block in (st.body, st.orelse, st.finalbody,
                          *(h.body for h in st.handlers)):
                _scan_captured(path, block, tn, where, findings)
        else:
            check_reads(st)
            tn.observe_assign(st)


# --------------------------------------------------------------------------
# host-sync-hot
# --------------------------------------------------------------------------


def _is_sync_call(node: ast.Call) -> bool:
    if dotted_name(node.func) in _HOST_SYNC_FUNCS:
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_SYNC_ATTRS and not node.args)


def _span_name(item: ast.withitem) -> Optional[str]:
    ctx = item.context_expr
    if (isinstance(ctx, ast.Call) and isinstance(ctx.func, ast.Attribute)
            and ctx.func.attr == "span" and ctx.args
            and isinstance(ctx.args[0], ast.Constant)
            and isinstance(ctx.args[0].value, str)):
        return ctx.args[0].value
    return None


def _check_pump_syncs(
    path: str, fn: ast.FunctionDef, findings: list[Finding]
) -> None:
    """Inside a router ``pump()`` only the ``*.sync`` / ``*.materialize``
    spans may wait for the card: a stray sync anywhere else stalls the
    host until the chunk just launched is done, which serializes the
    double-buffered pump."""

    def flag(node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _is_sync_call(sub):
                findings.append(Finding(
                    path, sub.lineno, "host-sync-hot",
                    "host sync in pump() outside a *.sync/*.materialize "
                    "span: serializes the double-buffered pump",
                ))

    def scan_flat(stmts: list[ast.stmt], allowed: bool) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                inner = allowed
                for item in st.items:
                    name = _span_name(item)
                    if name and name.endswith(_SYNC_SPAN_SUFFIXES):
                        inner = True
                    if not allowed:
                        flag(item.context_expr)
                scan_flat(st.body, inner)
            elif isinstance(st, (ast.If, ast.While)):
                if not allowed:
                    flag(st.test)
                scan_flat(st.body, allowed)
                scan_flat(st.orelse, allowed)
            elif isinstance(st, ast.For):
                if not allowed:
                    flag(st.iter)
                scan_flat(st.body, allowed)
                scan_flat(st.orelse, allowed)
            elif isinstance(st, ast.Try):
                for block in (st.body, st.orelse, st.finalbody,
                              *(h.body for h in st.handlers)):
                    scan_flat(block, allowed)
            elif not allowed:
                flag(st)

    scan_flat(fn.body, False)


# --------------------------------------------------------------------------
# obs-nonstatic
# --------------------------------------------------------------------------


def _check_obs_callsites(
    path: str, tree: ast.Module, findings: list[Finding]
) -> None:
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "span"):
            continue
        owner = dotted_name(node.func.value) or ""
        if "obs" not in owner.split("."):
            continue
        for value in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(value):
                if not isinstance(sub, ast.Call):
                    continue
                callee = dotted_name(sub.func)
                device = makes_tensor(callee) or (
                    isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _TENSOR_METHODS
                )
                if device:
                    what = callee or f".{sub.func.attr}()"
                    findings.append(Finding(
                        path, sub.lineno, "obs-nonstatic",
                        f"device work ({what}) in an obs.span(...) "
                        f"argument: hook arguments run even when tracing "
                        f"is off; pass host scalars",
                    ))


# --------------------------------------------------------------------------
# dead-shim
# --------------------------------------------------------------------------


def _check_dead_shims(
    path: str, tree: ast.Module, findings: list[Finding]
) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            removed = REMOVED_IMPORTS.get(node.module)
            if not removed:
                continue
            for alias in node.names:
                if alias.name in removed:
                    findings.append(Finding(
                        path, node.lineno, "dead-shim",
                        f"{node.module} offers no {alias.name!r} (repro "
                        f"removed it; the port never had it): use "
                        f"Reranker/RerankRequest from repro_torch.serving",
                    ))
        elif isinstance(node, ast.Attribute):
            dotted = dotted_name(node)
            if dotted in _REMOVED_DOTTED:
                findings.append(Finding(
                    path, node.lineno, "dead-shim",
                    f"{dotted} does not exist: use Reranker/RerankRequest "
                    f"from repro_torch.serving",
                ))
