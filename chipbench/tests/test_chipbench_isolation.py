"""The benchmark imports neither JAX nor the JAX package nor the JAX
package's benchmarks, and its reference nothing of the program; top-level
module names are compared whole (``repro_torch`` is not ``repro``)."""
import ast
from pathlib import Path

import pytest

from chipbench.run import forbidden_modules

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add((node.module or "").split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(HERE)) for p in FILES])
def test_no_jax_no_jax_package(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)


def test_the_run_refuses_jax_by_whole_top_level_names():
    assert forbidden_modules(["repro_torch.models.cnn", "torch"]) == []
    assert forbidden_modules(["repro.models.cnn", "jax.numpy", "flax"]) \
        == ["flax", "jax", "repro"]
    assert forbidden_modules(["jaxtyping", "reprocess"]) == []
