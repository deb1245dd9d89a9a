"""No module of the benchmark imports JAX, the JAX package or the JAX
package's benchmarks, and the reference imports nothing of the program.
Top-level names are compared whole: ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_only_torch(path):
    assert top_level_imports(path) <= {"__future__", "math", "typing",
                                       "torch"}


def test_the_check_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.serve\nfrom repro_torch import x\n")
    assert top_level_imports(probe) == {"repro_torch"}
    probe.write_text("import repro.serve\nfrom jax import numpy\n")
    assert top_level_imports(probe) & FORBIDDEN == {"repro", "jax"}
