"""Nothing under gwbench/ imports jax, jaxlib, flax or the JAX package, and
the reference imports nothing of the port: top-level module names compared
whole (``gwkit_torch`` begins with ``gwkit``)."""
import ast
from pathlib import Path

import pytest

from gwbench import files

FORBIDDEN = {"jax", "jaxlib", "flax", "gwkit"}
SOURCES = sorted(files.HERE.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(files.HERE)))
def test_no_jax_and_reference_without_the_port(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    if "reference" in path.relative_to(files.HERE).parts:
        assert "gwkit_torch" not in names


def test_whole_name_comparison():
    assert top_level_imports(files.HERE / "drivers" / "search.py") >= {"gwkit_torch"}
    assert "gwkit" not in {"gwkit_torch"}
