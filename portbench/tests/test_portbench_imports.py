"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program under test (top-level names
compared whole: ``dmtpu_torch`` is not ``dmtpu``)."""
import ast
from pathlib import Path

import pytest

from portbench.harness import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(ROOT.rglob("*.py"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    bad = [m for m in _imports(path) if m.split(".")[0] == "dmtpu_torch"]
    assert not bad, bad


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["dmtpu_torch", "dmtpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["dmtpu", "dmtpu.models", "jax.numpy", "flax", "optax"]) == [
        "dmtpu", "dmtpu.models", "flax", "jax.numpy", "optax"]
