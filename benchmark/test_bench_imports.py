"""Nothing that the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the program.  Top-level module names are
compared whole: ``fluidsim_tpu_torch`` begins with ``fluidsim_tpu``."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import harness

HERE = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "fluidsim_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py")
                 if not p.name.startswith(("test_", "conftest")))


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_in_the_sources(path):
    found = _top_level_imports(path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    if path.parent.name == "reference":
        assert "fluidsim_tpu_torch" not in found


def test_the_compare_by_whole_names():
    assert "fluidsim_tpu_torch".split(".")[0] not in FORBIDDEN
    assert harness.FORBIDDEN == FORBIDDEN


def test_a_run_loads_no_jax():
    """Import every module a run may load, with the program's sims, in a
    fresh interpreter, and look at ``sys.modules``."""
    mods = [".".join(p.relative_to(HERE.parent).with_suffix("").parts)
            for p in SOURCES if p.name != "run.py"]
    code = ("import sys, importlib\n"
            f"sys.path.insert(0, {str(HERE.parent)!r})\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "import fluidsim_tpu_torch.models.flip, fluidsim_tpu_torch.models.mpm\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
