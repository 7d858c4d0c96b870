"""Nothing under benchmark/ imports JAX, the JAX package or the scripts
that measure it; the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "kubernetes_tpu", "bench",
             "bench_matrix", "profile_bench", "chip_smoke", "kernel_ab"}


def imported(path: Path):
    """Top-level names of every module `path` imports, whole."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_forbidden_import(path):
    assert not set(imported(path)) & FORBIDDEN, path


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "kubernetes_tpu_torch" not in set(imported(path))


def test_names_compared_whole():
    from benchmark import run
    assert run.forbidden_modules(["kubernetes_tpu_torch.engine",
                                  "kubernetes_tpu_torch", "jaxtyping",
                                  "numpy"]) == []
    assert run.forbidden_modules(["kubernetes_tpu.ops", "jax.numpy",
                                  "flax"]) == ["flax", "jax",
                                               "kubernetes_tpu"]


def test_scan_catches_a_planted_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import numpy\nfrom kubernetes_tpu.ops import x\n"
                   "import importlib\nimportlib.import_module('jax')\n")
    assert set(imported(src)) & FORBIDDEN == {"kubernetes_tpu", "jax"}
