"""Nothing the benchmark runs imports JAX, Flax, Optax or the JAX package
(whole top-level names: the port's ``situation3d_tpu_torch`` is not one),
the reference imports nothing of the program, and no file reads the JAX
package's benchmark records."""
import ast
from pathlib import Path

import pytest

from benchmarks.harness.cell import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "situation3d_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "situation3d_tpu_torch" not in top_level_imports(path)


def test_the_check_is_whole_names():
    assert "situation3d_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_records_read(path):
    text = path.read_text()
    for name in ("BENCH_r", "MULTICHIP_r", "bench.py", "scripts/"):
        assert name not in text
