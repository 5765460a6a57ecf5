"""Launch-geometry checker (rules plan-key-tensor, plan-key-unhashable,
router-geometry, session-geometry): the port's counterpart of
``repro.analysis.jitgeo``.

Where JAX compiles one program per static signature, the port plans one
launch geometry per shape: the ``functools.lru_cache``-memoised plan
functions (``dpp_greedy.cluster_plan``, ``ops._stream_tile_memo``,
``scored_topk._plan``, ``tiled._capacity`` / ``capacity_fn``) key the
geometry, and the router and the session build their chunk launcher
once on state they allocate once.  Three jobs:

1. **plan keys** — a memoised plan function's parameter annotated as a
   tensor, or a call that passes it a tensor, re-plans per request (a
   tensor hashes by identity) and pins the tensor in the cache; an
   unhashable literal raises ``TypeError`` at the call.

2. **router geometry proof** — in the class that allocates the slot
   batch (``greedy_slots_init``) and builds its chunk launcher
   (``greedy_chunk_launcher``), every attribute feeding the launch
   geometry is written exactly once: in ``__init__``, or (the lazy ones)
   under their ``if self.x is None:`` guard; the launcher itself under
   the guard of the state it is built on.  With one build site and one
   launch site, every launch after warmup reuses the geometry the first
   admission planned: the static counterpart of figure 8's
   ``since_mark() == 0`` gate.

3. **session geometry proof** — the same for the class that solves
   deltas against its window (``window_solve``, the session marker): one
   launch site per family — the resume chunk (``greedy_chunk_launcher``)
   and the delta of ``extend`` and of ``rescore`` (``self._delta``),
   reported under ``repro``'s family names — and one delta solve, with
   write-once geometry attributes, so a resumed session reaches no
   geometry beyond (state shape, chunk, delta width).
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from repro_torch.analysis.astutil import (
    TensorNames,
    call_args,
    dotted_name,
    self_attr,
)
from repro_torch.analysis.findings import Finding

# the slot batch's state initialiser (the router marker), its chunk
# launcher builder and the one-call slot chunk
STATE_INIT = "greedy_slots_init"
CHUNK_LAUNCHER = "greedy_chunk_launcher"
CHUNK_SLOTS = "greedy_chunk_slots"

# the session marker: only the session layer solves a delta block
# against a resident window
SESSION_MARKER = "window_solve"
# repro's session family -> (the port's callee, the verb it must sit in;
# None: anywhere in the class)
SESSION_FAMILIES: dict[str, tuple[str, Optional[str]]] = {
    "greedy_chunk": (CHUNK_LAUNCHER, None),
    "greedy_state_extend": ("_delta", "extend"),
    "greedy_state_rescore": ("_delta", "rescore"),
}
_DELTA_VERBS = {verb for callee, verb in SESSION_FAMILIES.values()
                if callee == "_delta"}

_TENSORISH = ("Tensor", "ndarray")
_UNHASHABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                        ast.DictComp, ast.SetComp)


def check_module(path: str, tree: ast.Module,
                 memo_names: Iterable[str] = ()) -> list[Finding]:
    """The module's findings; ``memo_names`` are memoised plan functions
    defined in other modules of the run (their call sites here are
    checked too)."""
    findings: list[Finding] = []
    _check_plan_keys(path, tree, set(memo_names), findings)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for summary, rule in ((router_geometry_summary(node),
                                   "router-geometry"),
                                  (session_geometry_summary(node),
                                   "session-geometry")):
                if summary is not None:
                    for line, message in summary["violations"]:
                        findings.append(Finding(path, line, rule, message))
    return findings


# --------------------------------------------------------------------------
# plan-key-tensor / plan-key-unhashable
# --------------------------------------------------------------------------


def _is_memo_decorator(dec: ast.AST) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    return dotted_name(target) in ("functools.lru_cache", "lru_cache",
                                   "functools.cache", "cache")


def memo_functions(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    """The module's ``lru_cache``-memoised functions by name."""
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and any(_is_memo_decorator(d) for d in n.decorator_list)}


def _check_plan_keys(path: str, tree: ast.Module, memo_names: set[str],
                     findings: list[Finding]) -> None:
    local = memo_functions(tree)
    for name, fn in local.items():
        for arg in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs:
            ann = ast.unparse(arg.annotation) if arg.annotation else ""
            if any(tok in ann for tok in _TENSORISH):
                findings.append(Finding(
                    path, arg.lineno, "plan-key-tensor",
                    f"memoised plan function {name}() keys on parameter "
                    f"{arg.arg!r} annotated {ann!r}: a tensor hashes by "
                    f"identity (one plan per request, the tensor pinned)",
                ))
    names = memo_names | set(local)

    def scan(scope: ast.AST, tn: TensorNames) -> None:
        for node in ast.walk(scope):
            if isinstance(node, ast.stmt):
                tn.observe_assign(node)
            if not isinstance(node, ast.Call):
                continue
            callee = (dotted_name(node.func) or "").split(".")[-1]
            if callee not in names:
                continue
            for value in call_args(node):
                if isinstance(value, _UNHASHABLE_LITERALS):
                    findings.append(Finding(
                        path, value.lineno, "plan-key-unhashable",
                        f"unhashable literal passed to memoised plan "
                        f"function {callee}(): the call raises TypeError",
                    ))
                elif tn.is_tensor(value):
                    findings.append(Finding(
                        path, value.lineno, "plan-key-tensor",
                        f"tensor passed to memoised plan function "
                        f"{callee}(): it hashes by identity, so every "
                        f"request re-plans and the cache pins the tensor "
                        f"(pass its shape or device)",
                    ))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan(node, TensorNames())
    # module-level statements outside any function
    for st in tree.body:
        if not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            scan(st, TensorNames())


# --------------------------------------------------------------------------
# router-geometry
# --------------------------------------------------------------------------


def _calls_named(tree: ast.AST, name: str) -> list[ast.Call]:
    return [n for n in ast.walk(tree)
            if isinstance(n, ast.Call)
            and (dotted_name(n.func) or "").split(".")[-1] == name]


def _assigned_attrs(cls: ast.ClassDef, callee: str) -> set[str]:
    """``self.x`` targets of assignments whose value calls ``callee``
    (tuples included: ``self._launch = n, greedy_chunk_launcher(...)``)."""
    out: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _calls_named(node.value, callee):
            for target in node.targets:
                elts = (target.elts if isinstance(target, (ast.Tuple,
                                                           ast.List))
                        else [target])
                for t in elts:
                    attr = self_attr(t)
                    if attr is not None and isinstance(t, ast.Attribute):
                        out.add(attr)
    return out


def router_geometry_summary(cls: ast.ClassDef) -> Optional[dict]:
    """Prove (or refute) the one-launch-geometry property for a class
    that allocates a slot batch (``greedy_slots_init``) and launches
    chunks on it.

    Returns None for other classes.  Otherwise a dict: ``launch_sites``
    (calls of the built launcher, plus direct ``greedy_chunk_slots``
    calls), ``build_sites``, ``geometry_attrs`` (write-once, in
    ``__init__``), ``lazy_attrs`` (write-once under their ``is None``
    guard), ``launcher_attrs``, ``violations`` ([(line, message)]) and
    ``reachable_geometries`` (1 when there is no violation)."""
    inits = _calls_named(cls, STATE_INIT)
    builds = _calls_named(cls, CHUNK_LAUNCHER)
    direct = _calls_named(cls, CHUNK_SLOTS)
    if not inits or not (builds or direct):
        return None
    launchers = _assigned_attrs(cls, CHUNK_LAUNCHER)
    states = _assigned_attrs(cls, STATE_INIT)
    launches = direct + [
        n for n in ast.walk(cls)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and isinstance(n.func.value, ast.Name) and n.func.value.id == "self"
        and n.func.attr in launchers
    ]

    violations: list[tuple[int, str]] = []
    if len(builds) > 1:
        for call in builds[1:]:
            violations.append((
                call.lineno,
                f"{len(builds)} {CHUNK_LAUNCHER} build sites in class "
                f"{cls.name}: a second launcher can carry a second launch "
                f"geometry; build one",
            ))
    if len(launches) > 1:
        for call in sorted(launches, key=lambda c: c.lineno)[1:]:
            violations.append((
                call.lineno,
                f"{len(launches)} slot-chunk launch sites in class "
                f"{cls.name}: route every chunk through one",
            ))

    geometry: set[str] = set()
    lazy: set[str] = set()
    for call in builds + direct:
        for arg in call_args(call):
            attr = self_attr(arg)
            if attr is not None and not attr.startswith("_"):
                geometry.add(attr)
            # underscore arguments are the mutable slot state, pinned by
            # the initialiser's arguments below
    for call in inits:
        for arg in call_args(call):
            attr = self_attr(arg)
            if attr is not None:
                (lazy if attr.startswith("_") else geometry).add(attr)

    writes = _attr_writes(cls)
    for attr in sorted(geometry):
        for line, where, _ in writes.get(attr, []):
            if where != "__init__":
                violations.append((
                    line,
                    f"geometry attribute self.{attr} written outside "
                    f"__init__ (in {where}): the launch geometry could "
                    f"change after warmup",
                ))
    for attr in sorted(lazy):
        for line, where, guarded_by in writes.get(attr, []):
            if where != "__init__" and attr not in guarded_by:
                violations.append((
                    line,
                    f"lazy geometry attribute self.{attr} written in "
                    f"{where} outside its `if self.{attr} is None:` guard: "
                    f"it must materialise exactly once",
                ))
    for attr in sorted(launchers):
        for line, where, guarded_by in writes.get(attr, []):
            if where != "__init__" and not guarded_by & (states | {attr}):
                violations.append((
                    line,
                    f"chunk launcher self.{attr} built in {where} outside "
                    f"the `is None` guard of the state it launches on "
                    f"({', '.join(sorted(states))}): it must be built "
                    f"once, with that state",
                ))

    return {
        "class": cls.name,
        "launch_sites": len(launches),
        "build_sites": len(builds),
        "geometry_attrs": sorted(geometry),
        "lazy_attrs": sorted(lazy),
        "launcher_attrs": sorted(launchers),
        "violations": violations,
        "reachable_geometries": 1 if not violations else None,
    }


# --------------------------------------------------------------------------
# session-geometry
# --------------------------------------------------------------------------


def _methods(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _self_calls(fn: ast.AST) -> set[str]:
    return {n.func.attr for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "self"}


def _reachable(methods: dict, start: Iterable[str]) -> set[str]:
    """Methods reachable from ``start`` through ``self.`` calls."""
    seen: set[str] = set()
    todo = [m for m in start if m in methods]
    while todo:
        m = todo.pop()
        if m in seen:
            continue
        seen.add(m)
        todo.extend(c for c in _self_calls(methods[m]) if c in methods)
    return seen


def session_geometry_summary(cls: ast.ClassDef) -> Optional[dict]:
    """Prove (or refute) that a session class's resume and delta paths
    reach no launch geometry beyond (state shape, chunk, delta width).

    Fires on a class calling ``window_solve`` (the session marker).
    Every non-underscore attribute that reaches a launch — an argument
    of a family's call, or a read in the methods the delta runs — must
    be written only in ``__init__``; each family has one call site (in
    its verb); the delta solve has one.  Returns None for other classes,
    else a dict like :func:`router_geometry_summary` whose
    ``launch_sites`` maps ``repro``'s family names to counts."""
    solves = _calls_named(cls, SESSION_MARKER)
    if not solves:
        return None
    methods = _methods(cls)
    violations: list[tuple[int, str]] = []
    geometry: set[str] = set()
    sites: dict[str, int] = {}
    for family, (callee, verb) in SESSION_FAMILIES.items():
        scope = [methods[verb]] if verb is not None and verb in methods \
            else ([] if verb is not None else [cls])
        calls = [c for s in scope for c in _calls_named(s, callee)]
        sites[family] = len(calls)
        for call in calls[1:]:
            violations.append((
                call.lineno,
                f"{len(calls)} {family} launch sites ({callee}) in class "
                f"{cls.name}: a second site can carry a second launch "
                f"geometry; route every one through one",
            ))
        for call in calls:
            for arg in call_args(call):
                attr = self_attr(arg)
                if attr is not None and not attr.startswith("_"):
                    geometry.add(attr)
    for name, fn in methods.items():
        if name in _DELTA_VERBS:
            continue
        for call in _calls_named(fn, "_delta"):
            violations.append((
                call.lineno,
                f"a delta launched from {name}, not from "
                f"{'/'.join(sorted(_DELTA_VERBS))}: a family beyond "
                f"resume/extend/rescore",
            ))
    for call in solves[1:]:
        violations.append((
            call.lineno,
            f"{len(solves)} {SESSION_MARKER} sites in class {cls.name}: "
            f"every delta must solve through one",
        ))
    # the attributes the delta's device half reads
    for name in _reachable(methods, ["_delta"]):
        for node in ast.walk(methods[name]):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and isinstance(node.ctx, ast.Load)
                    and not node.attr.startswith("_")
                    and node.attr not in methods):
                geometry.add(node.attr)

    writes = _attr_writes(cls)
    for attr in sorted(geometry):
        for line, where, _ in writes.get(attr, []):
            if where != "__init__":
                violations.append((
                    line,
                    f"session geometry attribute self.{attr} written "
                    f"outside __init__ (in {where}): a resume after the "
                    f"write could reach a new launch geometry",
                ))
    return {
        "class": cls.name,
        "launch_sites": sites,
        "geometry_attrs": sorted(geometry),
        "violations": violations,
        "reachable_geometries": 1 if not violations else None,
    }


def _attr_writes(
    cls: ast.ClassDef,
) -> dict[str, list[tuple[int, str, frozenset[str]]]]:
    """All ``self.x = ...`` writes in the class:
    attr -> [(line, method name, attrs guarded by `is None` there)]."""
    writes: dict[str, list[tuple[int, str, frozenset[str]]]] = {}

    def guard_attrs(test: ast.AST) -> set[str]:
        """Attrs ``a`` with ``self.a is None`` asserted by ``test``."""
        out: set[str] = set()
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            for v in test.values:
                out |= guard_attrs(v)
        elif (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], ast.Is)
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None):
            attr = self_attr(test.left)
            if attr is not None:
                out.add(attr)
        return out

    def scan(stmts: list[ast.stmt], method: str,
             guarded: frozenset[str]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(st.body, method, guarded)
                continue
            targets: list[ast.AST] = []
            if isinstance(st, ast.Assign):
                targets = st.targets
            elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
                targets = [st.target]
            for target in targets:
                for t in (target.elts if isinstance(
                        target, (ast.Tuple, ast.List)) else [target]):
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        writes.setdefault(t.attr, []).append(
                            (st.lineno, method, guarded))
            if isinstance(st, ast.If):
                scan(st.body, method,
                     guarded | frozenset(guard_attrs(st.test)))
                scan(st.orelse, method, guarded)
            elif isinstance(st, (ast.While, ast.For)):
                scan(st.body, method, guarded)
                scan(st.orelse, method, guarded)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                scan(st.body, method, guarded)
            elif isinstance(st, ast.Try):
                for block in (st.body, st.orelse, st.finalbody,
                              *(h.body for h in st.handlers)):
                    scan(block, method, guarded)

    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan(node.body, node.name, frozenset())
    return writes

