"""No JAX in the benchmark: names compared by whole top-level module name."""

import ast
import subprocess
import sys

import pytest

from port_bench.core.harness import forbidden_modules
from port_bench.tests.conftest import ROOT

PORT = "learninghumanoidwalking_tpu_torch"


@pytest.mark.parametrize("name, flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True), ("optax", True),
    ("learninghumanoidwalking_tpu", True), ("learninghumanoidwalking_tpu.envs.jvrc_walk", True),
    (PORT, False), (f"{PORT}.rl.ppo", False), ("jaxtyping", False), ("flaxen", False), ("torch", False),
])
def test_top_level_names_compared_whole(name, flagged):
    assert (forbidden_modules([name]) == [name]) is flagged


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "port_bench/reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT / "port_bench/reference")))
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "optax", "learninghumanoidwalking_tpu", PORT, "port_bench"}, tops


def test_no_file_of_the_benchmark_imports_jax():
    for path in (ROOT / "port_bench").rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "optax", "learninghumanoidwalking_tpu"}, path


def test_reference_and_harness_load_no_jax():
    """Importing the harness, the reference and the port's trainer and env
    leaves no module of the JAX stack or the JAX package loaded."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.core.harness, port_bench.core.check, port_bench.reference.physics\n"
            "import learninghumanoidwalking_tpu_torch.rl.ppo, learninghumanoidwalking_tpu_torch.envs.jvrc_walk\n"
            "from port_bench.core.harness import forbidden_modules\n"
            "print(forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    """No card: exit 2, nothing on standard output (no CPU fallback)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "jvrc_walk.train32k", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
