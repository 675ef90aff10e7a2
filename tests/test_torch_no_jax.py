"""The PyTorch port stands alone: importing any of its modules pulls in
neither JAX nor ml_dtypes nor any module of the JAX package ``repro``."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_imports_leave_jax_and_repro_out():
    mods = _port_modules()
    assert "repro_torch.core.scheduler" in mods
    assert {"repro_torch.sim", "repro_torch.sim.fleet",
            "repro_torch.sim.async_agg", "repro_torch.sim.agg_tree"} <= \
        set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
        "print(json.dumps(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_never_import_jax_or_repro():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for name in _imported_names(tree):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "ml_dtypes", "repro"):
                offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert offenders == []


def test_chip_smoke_never_imports_jax_or_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    tops = {n.split(".")[0] for n in _imported_names(tree)}
    assert not tops & {"jax", "jaxlib", "ml_dtypes", "repro"}
