"""The benchmark imports neither JAX nor the JAX package, and its reference
imports nothing of the program under test.

Top-level module names are compared whole (the part before the first dot):
the program's package, ``repro_torch``, begins with the JAX package's
name, ``repro``, and is not it."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_top_names(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (absolute imports;
    a relative import stays inside the benchmark)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def bench_sources() -> list[Path]:
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_the_walk_finds_the_harness_and_the_reference():
    rel = {p.relative_to(BENCH).as_posix() for p in bench_sources()}
    assert {"run.py", "harness.py", "check.py", "reference/taco_ref.py"} <= rel


@pytest.mark.parametrize("path", bench_sources(), ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported_top_names(path)


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.ann\nfrom repro_torch import kernels\n"
                   "import jaxtyping\nfrom repro.core import taco\n")
    assert imported_top_names(src) == {"repro_torch", "jaxtyping", "repro"}
    assert imported_top_names(src) & FORBIDDEN == {"repro"}


def test_run_refuses_loaded_jax_by_whole_names():
    from anns_bench.run import forbidden_loaded

    assert forbidden_loaded(["repro_torch", "repro_torch.ann", "jaxtyping", "torch"]) == []
    assert forbidden_loaded(["repro.core.taco", "jax.numpy", "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "repro"]
