"""Nothing under portbench/ imports JAX or the JAX package, by top-level
module name compared whole, and nothing names the JAX package's benchmark
folder."""

import ast
import sys

import pytest

from portbench import run

from .conftest import HERE

OLD_BENCH = "bench" + "marks/"          # the JAX package's benchmark folder
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import(path):
    assert run.forbidden_modules(list(_imports(path))) == []
    assert OLD_BENCH not in path.read_text()


@pytest.mark.parametrize("modules,found", [
    (["nlsolvers_tpu_torch", "nlsolvers_tpu_torch.ops.krylov"], []),
    (["nlsolvers_tpu.ops"], ["nlsolvers_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen", "numpy"],
     ["flax", "jax", "jaxlib"]),
    (["jax_extra", "flaxen"], []),
])
def test_forbidden_names_compared_whole(modules, found):
    assert run.forbidden_modules(modules) == found


def test_run_loads_no_jax():
    """Importing the harness and the port loads no forbidden module (this
    test process may hold JAX from elsewhere: compare what the harness
    adds)."""
    before = set(run.forbidden_modules())
    import nlsolvers_tpu_torch.pipeline.datagen  # noqa: F401
    from portbench import bench, check, control  # noqa: F401
    assert set(run.forbidden_modules()) == before
    assert "jax" not in sys.modules or "jax" in before
