"""The work count behind the kernels' roofline bound
(ops/substep_kernel.py::flops_per_env_substep) against bench.py's count of
the Pallas kernel (bench.py:53), which traces one Pallas substep group and
counts its elementwise operations; and the wrapper's model check.

The port counts the least work of a step: the Woodbury contact solve of the
Pallas kernel, with triangular factorizations and solves at their
triangular size and reductions counted. bench.py counts the Pallas kernel's
triangular updates at full row length and no reductions, so the port's
count may not exceed bench.py's and stays within 25% below it. A count of
the dense 3nc x 3nc contact solve that K1 itself runs (more than 1.5x
bench.py's) fails, so the bound cannot be inflated by K1's own algorithm.
The terrain-box model (jvrc_step: 20 boxes, 16 slots) is counted at R=1, as
the reference and K2 run it.
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


@pytest.mark.parametrize(
    "nterrain, reuse", [pytest.param(0, 1, id="1"), pytest.param(0, 5, id="5"), pytest.param(20, 1, id="boxes-1")]
)
def test_flop_count_is_the_woodbury_form(nterrain, reuse):
    traced = _bench()._kernel_flops_per_env_substep(jax_lower(jax_jvrc.jvrc_spec(nterrain=nterrain)), reuse)
    counted = sk.flops_per_env_substep(lower(jvrc.jvrc_spec(nterrain=nterrain), device="cpu"), reuse)
    assert 0.75 * traced <= counted <= traced, (counted, traced)


# the caps the two builds report (csrc/control_step.cu, LHW_TERRAIN 0 / 1)
CAPS = dict(MAX_B=16, MAX_V=20, MAX_Q=21, MAX_U=16, MAX_F=2)
FLAT = dict(CAPS, LHW_TERRAIN=0, MAX_C=8, MAX_T=0, MAX_HF=0)
TERRAIN = dict(CAPS, LHW_TERRAIN=1, MAX_C=16, MAX_T=32, MAX_HF=1024)


def test_check_model_takes_terrain_and_refuses_motor_models():
    flat, boxes = lower(jvrc.jvrc_spec(), device="cpu"), lower(jvrc.jvrc_spec(nterrain=20), device="cpu")
    sk.check_model(flat, FLAT)
    sk.check_model(boxes, TERRAIN)  # K2
    sk.check_model(flat, TERRAIN, hfield_shape=(16, 16))  # K3
    with pytest.raises(ValueError, match="terrain build"):
        sk.check_model(boxes, FLAT)
    with pytest.raises(ValueError, match="terrain build"):
        sk.check_model(flat, FLAT, hfield_shape=(16, 16))
    with pytest.raises(ValueError, match="heightfield"):
        sk.check_model(flat, TERRAIN, hfield_shape=(64, 64))
    with pytest.raises(ValueError, match="terrain boxes exceed"):
        sk.check_model(lower(jvrc.jvrc_spec(nterrain=40), device="cpu"), TERRAIN)
    with pytest.raises(ValueError, match="K4"):
        sk.check_model(boxes, TERRAIN, motor=object())
    assert [sk.variant(flat, False), sk.variant(boxes, False), sk.variant(flat, True)] == ["K1", "K2", "K3"]
