"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port; module names are compared by their
top-level name, whole."""

import ast

import pytest

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vexpress_tpu"}
FILES = sorted(spec.HERE.rglob("*.py"))


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_not_the_port(path):
    assert "vexpress_torch" not in imported(path)
    assert all(not n.startswith("vexpress") for n in imported(path))


def test_the_scan_sees_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom vexpress_tpu.models import x\n"
                     "import vexpress_torch_extra\n")
    assert imported(probe) == {"jax", "vexpress_tpu", "vexpress_torch_extra"}
