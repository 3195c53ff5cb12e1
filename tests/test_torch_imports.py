"""The torch port and chip_smoke.py import no JAX-side module.

Every .py file of learninghumanoidwalking_tpu_torch/ and chip_smoke.py is
parsed and each import statement checked: the port must run where jax,
flax, optax, yaml and tensorboardX are not installed, and must not reach
into the JAX package (learninghumanoidwalking_tpu), not even for its numpy
modules.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "yaml", "tensorboardX", "orbax", "learninghumanoidwalking_tpu"}
FILES = sorted((REPO / "learninghumanoidwalking_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_files():
    assert len(FILES) > 20
    assert (REPO / "chip_smoke.py").exists()
    assert REPO / "learninghumanoidwalking_tpu_torch" / "robots" / "motor.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_side_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
