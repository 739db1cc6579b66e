"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the program: checked by each imported
module's top-level name, the part before the first dot, compared whole
(`afp_tpu_torch` is the program and passes; `afp_tpu` fails)."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "afp_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    """Top-level names of every module `path` imports (absolute imports)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_rule_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import afp_tpu_torch.engine\nfrom afp_tpu_torch import cli\n")
    assert top_level_imports(f) & FORBIDDEN == set()
    f.write_text("import afp_tpu.engine\n")
    assert top_level_imports(f) & FORBIDDEN == {"afp_tpu"}
    f.write_text("from jax import numpy\n")
    assert top_level_imports(f) & FORBIDDEN == {"jax"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert top_level_imports(path) & FORBIDDEN == set()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "numpy"}


def test_the_run_rejects_forbidden_modules_by_whole_name():
    code = ("import sys; sys.path.insert(0, %r); import perfbench.run as r; "
            "sys.modules['afp_tpu_torch_x'] = sys; print(r.forbidden_modules()); "
            "sys.modules['afp_tpu.engine'] = sys; print(r.forbidden_modules())"
            % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split("\n")
    assert out[0] == "[]"
    assert out[1] == "['afp_tpu']"
