"""Nothing under bench/ imports JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``); the plain reference
imports nothing of the program; the load generator and the traffic
generator import neither torch nor the program."""
import ast

import pytest

from bench.common import BENCH, FORBIDDEN, forbidden_modules

SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


@pytest.mark.parametrize("name", ["loadgen.py", "traffic.py", "common.py"])
def test_light_modules(name):
    assert not top_level_imports(BENCH / name) & {"torch", "repro_torch"}


def test_forbidden_compares_whole_names():
    assert forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping",
                              "flaxen", "numpy"]) == []
    assert forbidden_modules(["repro", "repro.core", "jax.numpy", "jaxlib",
                              "flax.linen"]) == sorted(
        ["repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"])


def test_ast_scan_sees_imports():
    src = BENCH / "tests" / "test_bench_imports.py"
    assert {"ast", "pytest", "bench"} <= top_level_imports(src)
