"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Import names are compared by
their top-level name, whole: scheme_raytrace_torch begins with the JAX
package's name and is not it."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "scheme_raytrace_tpu"}


def top_level_imports(path):
    """Top-level names of every module a file imports (relative imports
    resolve inside rtbench)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("rtbench" if node.level else node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    names = top_level_imports(path)
    assert "scheme_raytrace_torch" not in names
    # inside rtbench the reference imports only itself
    if "rtbench" in names:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.level <= 1
                assert node.level or not node.module.startswith("rtbench")
    assert names <= {"rtbench", "torch", "numpy", "math", "dataclasses",
                     "__future__"}


def test_the_name_check_is_whole():
    assert "scheme_raytrace_torch" not in JAX
    assert top_level_imports(Path(__file__)) & JAX == set()
