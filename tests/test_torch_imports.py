"""The port stands alone: ``repro_torch`` imports neither JAX nor
anything of ``repro``, and importing it builds or launches nothing.

Checked twice: statically, by an AST scan of every module's imports, and
dynamically, by importing every module in a fresh interpreter and
asserting that no ``jax`` or ``repro`` module was loaded.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports_of(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
    return bad


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_repro_imports(path):
    bad = _imports_of(path)
    assert not bad, f"{path}: imports {bad}"


def test_chip_smoke_imports_no_jax_or_repro():
    path = ROOT / "chip_smoke.py"
    bad = _imports_of(path)
    assert not bad, f"{path}: imports {bad}"


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "repro_torch.serving.api" in mods
    assert "repro_torch.core.streaming" in mods
    assert "repro_torch.models.recsys" in mods
    assert "repro_torch.launch.serve" in mods
    for mod in ("models.layers", "models.moe", "models.transformer",
                "models.gnn", "models.convert", "configs.qwen15_4b",
                "configs.graphcast", "examples.lm_rerank"):
        assert f"repro_torch.{mod}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
