"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pytorch_geometric_temporal_tpu"}
PORT = "pytorch_geometric_temporal_tpu_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_check_compares_whole_names():
    assert "pytorch_geometric_temporal_tpu" in FORBIDDEN
    assert PORT.split(".", 1)[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "warnings",
                                       "numpy", "torch"}
