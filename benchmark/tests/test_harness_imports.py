"""The import boundary: nothing under ``benchmark/`` imports JAX, flax or
the JAX package, and nothing under ``benchmark/reference/`` imports the
port. Each import's top-level name (the part before the first dot) is
compared whole: the port's name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "baryon_painter_tpu"}
PORT = "baryon_painter_tpu_torch"


def _imports(path: Path) -> set:
    """The top-level names a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    assert PORT not in _imports(path)
    assert "benchmark" not in _imports(path) or all(
        n.startswith(("benchmark.reference",))
        for n in _from_benchmark(path))


def _from_benchmark(path: Path) -> list:
    return [node.module for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.ImportFrom) and node.level == 0
            and node.module.split(".")[0] == "benchmark"]


def test_the_names_are_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import baryon_painter_tpu_torch.painter\n"
                     "import jaxtyping\nfrom jax import numpy\n")
    assert _imports(probe) & FORBIDDEN == {"jax"}
