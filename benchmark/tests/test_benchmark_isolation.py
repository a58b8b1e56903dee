"""What the benchmark's files import: nothing of JAX or the JAX package
anywhere (top-level names compared whole: ``cylon_tpu_torch`` is not
``cylon_tpu``); nothing of the program in the references and the input
generators; the program only from the cell's workload kinds and the
runner (its telemetry)."""

import ast

import pytest

from benchmark.harness import cell as cells

FORBIDDEN = {"jax", "jaxlib", "flax", "cylon_tpu"}
PROGRAM = "cylon_tpu_torch"
FILES = sorted(p for p in cells.BENCH_DIR.rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(cells.BENCH_DIR)
                         .as_posix())
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_references_and_generators_import_nothing_of_the_program():
    for sub in ("reference", "data", "harness", "metrics"):
        for path in (cells.BENCH_DIR / sub).glob("*.py"):
            assert PROGRAM not in top_level_imports(path), path


def test_only_kinds_and_the_runner_reach_the_program():
    users = {p.relative_to(cells.BENCH_DIR).as_posix() for p in FILES
             if PROGRAM in top_level_imports(p)}
    allowed = {p for p in users if p.startswith(("kinds/", "tests/"))}
    assert users - allowed <= {"run.py"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys

    from benchmark import run

    monkeypatch.setitem(sys.modules, "cylon_tpu_torch_fake", object())
    assert "cylon_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert run.forbidden_modules() == ["jaxlib"]
