"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program. Names are compared by their whole
top-level part: ``jssenv_tpu_torch`` is not ``jssenv_tpu``."""

import ast
import re
from pathlib import Path

import pytest

from perfbench import run

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "jssenv_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"jssenv_tpu_torch"})


def _code_strings(path: Path):
    """The string literals of a source that are not docstrings."""
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_file_of_the_old_benchmarks_is_read():
    """The docstrings of the frozen counts cite ``chip_smoke.py`` as their
    source; no code names it, ``bench.py``, ``tools/`` or their records."""
    pattern = re.compile(r"bench\.py|chip_smoke|BENCH_r|MULTICHIP_|BASELINE\.|^tools/")
    for path in SOURCES:
        if path.name != Path(__file__).name:
            assert not [s for s in _code_strings(path) if pattern.search(s)], path


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jssenv_tpu_torch_fake", types.ModuleType("jssenv_tpu_torch_fake"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jssenv_tpu.core", types.ModuleType("jssenv_tpu.core"))
    assert run.loaded_forbidden() == ["jssenv_tpu.core"]
