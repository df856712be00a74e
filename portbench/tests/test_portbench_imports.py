"""The import audit: nothing the benchmark runs imports JAX or the JAX
package, and the plain reference imports nothing of the program.

Top-level module names are compared whole (the part before the first dot):
the program's package, ``ddl_tpu_torch``, begins with the JAX package's
name and passes by design."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ddl_tpu"}
PROGRAM = "ddl_tpu_torch"
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set[str]:
    """The top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_the_audit_sees_every_module():
    names = {p.relative_to(BENCH).as_posix() for p in MODULES}
    assert {"run.py", "calibrate.py", "reference/lm.py", "runners/lm_train.py"} <= names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import ddl_tpu_torch.ops\nfrom ddl_tpu_torch import cli\nimport jaxtyping\n")
    assert top_level_imports(src) == {"ddl_tpu_torch", "jaxtyping"}
    assert not top_level_imports(src) & FORBIDDEN
    src.write_text("from ddl_tpu.models import cnn\nimport jax.numpy as jnp\n")
    assert top_level_imports(src) == {"ddl_tpu", "jax"}
