"""Nothing under h100_bench imports JAX or the JAX package `repro` (top-level
names compared whole: `repro_torch` is the program, not `repro`), nothing
under h100_bench/reference imports the program, and a run's guard finds
what a process loaded."""
import ast
import sys

import pytest

from h100_bench import harness
from h100_bench.tests.conftest import BENCH

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "spec_from_file_location"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    yield a.value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(imported(path)) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not set(imported(path)) & {"repro_torch", "repro", "jax"}
    allowed = {"__future__", "dataclasses", "typing", "torch", "numpy",
               "math", "h100_bench"}
    assert set(imported(path)) <= allowed


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_for_guard", sys)
    assert "repro" not in harness.forbidden_modules() or "repro" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert "jax" in harness.forbidden_modules()
