"""Nothing under portbench/ imports JAX, flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ei_nexus_tpu"}
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    assert not FORBIDDEN & set(top_level_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert "ei_nexus_tpu_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch", "portbench"}


def test_the_check_sees_an_import():
    src = "import jax.numpy\nfrom ei_nexus_tpu.ops import x\n"
    probe = BENCH / ".cache" / "probe_imports.py"
    probe.parent.mkdir(exist_ok=True)
    probe.write_text(src)
    try:
        assert {"jax", "ei_nexus_tpu"} <= set(top_level_imports(probe))
    finally:
        probe.unlink()
