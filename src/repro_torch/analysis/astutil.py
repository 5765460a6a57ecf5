"""Shared AST plumbing for the static checkers (stdlib ``ast`` only).

:class:`TensorNames` is the port's "is this expression a tensor"
evaluator, precise over complete: taint starts at ``torch.`` calls that
make tensors and flows through assignments, subscripts, arithmetic and
tensor methods; shape-family reads, ``is None`` checks and the host-valued
``torch`` calls (``torch.device``, ``torch.Size`` ...) launder it.  A
name with no provable taint (a parameter, an attribute, a helper's
result) is taken for a host value, so a finding always names a value the
code itself made on the device.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, Iterator, Optional

# attribute reads that give host values even on tensors
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad"}
# tensor methods that give host values
STATIC_METHODS = {"dim", "size", "numel", "element_size", "stride",
                  "is_contiguous", "data_ptr", "get_device", "nelement"}
# calls that give host values from tensor arguments
STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr", "range",
                "tuple", "list", "str", "repr", "id", "enumerate", "zip",
                "sorted"}
# torch.<name>(...) calls that give host values
HOST_TORCH = {"device", "Size", "finfo", "iinfo", "dtype", "promote_types",
              "get_default_dtype", "is_tensor", "is_floating_point",
              "result_type", "can_cast", "is_grad_enabled", "inference_mode",
              "no_grad", "manual_seed", "Generator"}
# torch submodules whose calls make tensors (torch.cuda.* and the rest are
# host-side: streams, events, device queries)
TENSOR_SUBMODULES = {"nn", "linalg", "fft", "special"}


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    """Expand files/directories into .py files (sorted, deduplicated),
    skipping hidden directories and __pycache__."""
    seen = set()
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py") and path not in seen:
                seen.add(path)
                yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(
                d for d in dirs
                if not d.startswith(".") and d != "__pycache__"
            )
            for name in sorted(files):
                full = os.path.join(root, name)
                if name.endswith(".py") and full not in seen:
                    seen.add(full)
                    yield full


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` -> that string; None when the
    expression is not a plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def self_attr(node: ast.AST) -> Optional[str]:
    """``self.x`` (or the ``self.x`` root of ``self.x.y``) -> ``"x"``."""
    while isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        node = node.value
    return None


def call_args(call: ast.Call) -> list[ast.AST]:
    """The positional and keyword argument expressions of ``call``."""
    return list(call.args) + [kw.value for kw in call.keywords]


def makes_tensor(callee: Optional[str]) -> bool:
    """Whether a call of the dotted name ``callee`` makes a tensor:
    ``torch.<fn>`` outside :data:`HOST_TORCH`, or a function of
    ``torch.nn``/``linalg``/``fft``/``special``."""
    if callee is None or not callee.startswith("torch."):
        return False
    parts = callee.split(".")
    if len(parts) == 2:
        return parts[1] not in HOST_TORCH and not parts[1][:1].isupper()
    return parts[1] in TENSOR_SUBMODULES


class TensorNames:
    """Which local names hold tensors in one scope, and which
    expressions are tensors (see the module docstring)."""

    def __init__(self, tensors: Iterable[str] = ()):  # noqa: D107
        self.names = set(tensors)

    def observe_assign(self, node: ast.stmt) -> None:
        if isinstance(node, ast.Assign):
            value, targets = node.value, node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            value, targets = node.value, [node.target]
        elif isinstance(node, ast.AugAssign):
            value, targets = node.value, [node.target]
        else:
            return
        tensor = self.is_tensor(value)
        for target in targets:
            for name in target_names(target):
                if tensor:
                    self.names.add(name)
                elif not isinstance(node, ast.AugAssign):
                    self.names.discard(name)

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            return self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tensor(e) for e in node.elts)
        if isinstance(node, ast.UnaryOp):
            return (not isinstance(node.op, ast.Not)
                    and self.is_tensor(node.operand))
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tensor(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        if isinstance(node, ast.Compare):
            # `x is None` is a host identity check even on tensors
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.is_tensor(node.left) or any(
                self.is_tensor(c) for c in node.comparators)
        if isinstance(node, ast.Call):
            callee = dotted_name(node.func)
            if callee in STATIC_CALLS:
                return False
            if makes_tensor(callee):
                return True
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in STATIC_METHODS:
                    return False
                # a method of a tensor gives a tensor (x.sum(), x.to())
                return self.is_tensor(node.func.value)
            return False
        return False


def target_names(target: ast.AST) -> Iterator[str]:
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from target_names(e)
    elif isinstance(target, ast.Starred):
        yield from target_names(target.value)
