"""The port's jvrc Model equals the JAX package's lower(jvrc_spec()).

Array fields must match to 1e-7 (both sides cast the same float64 numpy
values to float32; the lowering code is a copy), static tuples exactly.
"""

import dataclasses

import numpy as np

from learninghumanoidwalking_tpu.models.jvrc import jvrc_spec as jax_jvrc_spec
from learninghumanoidwalking_tpu.physics.spec import lower as jax_lower
from learninghumanoidwalking_tpu_torch.models.jvrc import jvrc_spec
from learninghumanoidwalking_tpu_torch.physics import model as tmodel
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)


def test_jvrc_model_matches_jax():
    ref = jax_lower(jax_jvrc_spec())
    got = lower(jvrc_spec(), device="cpu")
    assert (got.nq, got.nv, got.nu, got.nbody, got.ncon) == (19, 18, 12, 15, 8)
    for f in dataclasses.fields(got):
        mine = getattr(got, f.name)
        theirs = getattr(ref, f.name)
        if f.name in tmodel._STATIC_FIELDS:
            assert mine == theirs, f.name
        else:
            theirs = np.asarray(theirs)
            mine = mine.numpy()
            assert mine.dtype == np.float32 and mine.shape == theirs.shape, f.name
            np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-7, err_msg=f.name)


def test_model_host_copies_are_cached():
    m = lower(jvrc_spec(), device="cpu")
    np.testing.assert_array_equal(m.np("body_mass"), m.body_mass.numpy())
    assert m.host is m.host
