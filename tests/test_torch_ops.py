"""The work count behind K1's roofline bound
(ops/substep_kernel.py::flops_per_env_substep) against bench.py's count of
the Pallas kernel (bench.py:53), which traces one Pallas substep group and
counts its elementwise operations.

The port counts the least work of a step: the Woodbury contact solve of the
Pallas kernel, with triangular factorizations and solves at their
triangular size and reductions counted. bench.py counts the Pallas kernel's
triangular updates at full row length and no reductions, so the port's
count may not exceed bench.py's and stays within 25% below it. A count of
the dense 3nc x 3nc contact solve that K1 itself runs (more than 1.5x
bench.py's) fails, so the bound cannot be inflated by K1's own algorithm.
"""

import importlib.util
from pathlib import Path

import pytest

from learninghumanoidwalking_tpu.models import jvrc as jax_jvrc
from learninghumanoidwalking_tpu.physics.spec import lower as jax_lower
from learninghumanoidwalking_tpu_torch.models import jvrc
from learninghumanoidwalking_tpu_torch.ops import substep_kernel as sk
from learninghumanoidwalking_tpu_torch.physics.spec import lower


def _bench():
    spec = importlib.util.spec_from_file_location("bench", Path(__file__).resolve().parents[1] / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("reuse", [1, 5])
def test_flop_count_is_the_woodbury_form(reuse):
    traced = _bench()._kernel_flops_per_env_substep(jax_lower(jax_jvrc.jvrc_spec()), reuse)
    counted = sk.flops_per_env_substep(lower(jvrc.jvrc_spec(), device="cpu"), reuse)
    assert 0.75 * traced <= counted <= traced, (counted, traced)
