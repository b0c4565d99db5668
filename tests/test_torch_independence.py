"""libzl_tpu_torch and chip_smoke.py import nothing of the JAX package.

The port keeps its own copy of every reference module it runs, so no
module of it, and not chip_smoke.py, may import `libzl_tpu` or any module
under it, at the top or inside a function. This scans each file's syntax
tree; tests/test_torch_engine.py::test_port_never_imports_jax checks the
same at run time in a subprocess.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "libzl_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def imported_modules(tree: ast.AST) -> list:
    """(line, absolute module name) of every import in the tree."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module or ""))
    return out


@pytest.mark.parametrize("rel", FILES)
def test_no_libzl_tpu_import(rel):
    tree = ast.parse((REPO / rel).read_text())
    bad = [(line, m) for line, m in imported_modules(tree)
           if m.split(".")[0] in ("libzl_tpu", "jax", "jaxlib")]
    assert not bad, f"{rel} imports {bad}"


def test_the_scan_covers_the_whole_port():
    """The port's later modules are scanned too: sharding, the examples,
    the torch stretch and the session copy."""
    for rel in ("libzl_tpu_torch/parallel/sharding.py",
                "libzl_tpu_torch/examples/multichip_demo.py",
                "libzl_tpu_torch/examples/groovebox_demo.py",
                "libzl_tpu_torch/ops/stretch_torch.py",
                "libzl_tpu_torch/models/session.py"):
        assert rel in FILES, rel


def test_the_scan_sees_every_import_form():
    src = ("import libzl_tpu\n"
           "import os, libzl_tpu.io.wav as w\n"
           "from libzl_tpu.engine import engine\n"
           "def f():\n"
           "    from libzl_tpu import constants\n"
           "from libzl_tpu_torch import convert\n"
           "from . import voice\n")
    names = [m for _, m in imported_modules(ast.parse(src))]
    assert [m for m in names if m.split(".")[0] == "libzl_tpu"] == [
        "libzl_tpu", "libzl_tpu.io.wav", "libzl_tpu.engine", "libzl_tpu"]
    assert "libzl_tpu_torch" in names
