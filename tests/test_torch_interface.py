"""The port's physics/interface.py against the JAX package's, accessor by
accessor, on the CPU.

The states are the port's own (jvrc_walk and h1, 4 envs, a seeded reset
and 3 control steps of random actions: feet in contact, bodies moving, h1's
perturbation wrenches drawn), handed to the JAX accessors as the same
numbers, vmapped over the envs. So each case holds one read-out, not the
physics. Every public function of the JAX module is a case of its own.
Tolerances: tables, indices, names and contact masks exactly; float
results 1e-5 of the quantity's largest magnitude (at least 1).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learninghumanoidwalking_tpu.envs import make_env as make_jax_env
from learninghumanoidwalking_tpu.physics import interface as jitf
from learninghumanoidwalking_tpu.physics import model as jmodel
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.physics import interface as titf
from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

ACCESSORS = sorted(
    name for name, fn in inspect.getmembers(jitf, inspect.isfunction)
    if fn.__module__ == jitf.__name__ and not name.startswith("_")
)
ROBOTS = ("jvrc_walk", "h1")
B = 4


@pytest.fixture(scope="module")
def states():
    """Per robot: (JAX model, port model, JAX state, port state, JAX dyn, port dyn)."""
    out = {}
    for name in ROBOTS:
        tenv = make_env(name, device="cpu")
        gen = torch.Generator().manual_seed(4)
        draws = Draws(gen)
        st = tenv.reset_batch(B, draws)
        for _ in range(3):
            st = tenv.step_batch(st, 0.1 * torch.randn((B, tenv.action_size), generator=gen), draws)
        ph = st.physics
        contact = jmodel.Contact(**{f: jnp.asarray(getattr(ph.contact, f).numpy()) for f in ("pos", "frame", "dist", "geom", "force", "mask")})
        jstate = jmodel.PhysicsState(contact=contact, **{f: jnp.asarray(getattr(ph, f).numpy())
                                                         for f in ("qpos", "qvel", "qacc", "act_torque", "xpos", "xquat", "cvel", "time")})
        jdyn = jmodel.DynParams(**{f: jnp.asarray(getattr(st.dyn, f).numpy()) for f in
                                   ("dof_damping", "dof_frictionloss", "body_mass", "body_ipos", "xfrc", "kp", "kd", "bemf_gain")})
        out[name] = (make_jax_env(name).model, tenv.model, jstate, ph, jdyn, st.dyn)
    return out


def _calls(name, jm, tm, js, ts, jd, td):
    """(JAX call over one env's state, port call over the batch) of accessor ``name``."""
    body = tm.body_names[2]
    joint = tm.joint_names[tm.actuator_body[0]]
    if name in ("jnt_id_by_name", "jnt_qposadr_by_name", "jnt_qveladr_by_name"):
        return lambda: getattr(jitf, name)(jm, joint), lambda: getattr(titf, name)(tm, joint)
    if name.startswith("object_"):
        return lambda s: getattr(jitf, name)(jm, s, body), lambda: getattr(titf, name)(tm, ts, body)
    if name == "body_velocity":
        return lambda s: jitf.body_velocity(jm, s, 3, local=True), lambda: titf.body_velocity(tm, ts, 3, local=True)
    if name in ("body_floor_contacts", "body_contact_force"):
        return lambda s: getattr(jitf, name)(jm, s, jm.left_foot_geoms), lambda: getattr(titf, name)(tm, ts, tm.left_foot_geoms)
    if name == "body_ext_force":
        return lambda d: jitf.body_ext_force(jm, d, 1), lambda: titf.body_ext_force(tm, td, 1)
    params = list(inspect.signature(getattr(jitf, name)).parameters)
    if params[0] == "state":
        return lambda s: getattr(jitf, name)(s), lambda: getattr(titf, name)(ts)
    if params == ["model"]:
        return lambda: getattr(jitf, name)(jm), lambda: getattr(titf, name)(tm)
    return lambda s: getattr(jitf, name)(jm, s), lambda: getattr(titf, name)(tm, ts)


def _leaves(x) -> list:
    return [y for part in x for y in _leaves(part)] if isinstance(x, tuple) and x and not isinstance(x[0], (str, int)) else [x]


def test_the_port_has_every_accessor():
    assert len(ACCESSORS) >= 42
    assert [name for name in ACCESSORS if not callable(getattr(titf, name, None))] == []


@pytest.mark.parametrize("name", ACCESSORS)
def test_accessor_matches_jax(name, states):
    for robot in ROBOTS:
        jm, tm, js, ts, jd, td = states[robot]
        jcall, tcall = _calls(name, jm, tm, js, ts, jd, td)
        if len(inspect.signature(jcall).parameters) == 0:  # a model lookup: the same value
            want, got = jcall(), tcall()
            if isinstance(want, (int, str, tuple)):
                assert got == want, (robot, name)
            else:
                np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=f"{robot} {name}")
            continue
        want = jax.vmap(jcall)(jd if name == "body_ext_force" else js)
        for w, g in zip(_leaves(want), _leaves(tcall()), strict=True):
            w, g = np.asarray(w), g.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, (robot, name, g.shape, w.shape, g.dtype, w.dtype)
            if w.dtype == np.bool_ or name.endswith("floor_contacts"):
                np.testing.assert_array_equal(g, w, err_msg=f"{robot} {name}")
            else:
                scale = max(float(np.abs(w).max()), 1.0)
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale, err_msg=f"{robot} {name}")


def test_contacts_carry_the_robots_weight(states):
    """Read-outs that mean something on these states: both feet down, the
    ground reaction near the weight, no bad collision."""
    for robot in ROBOTS:
        _, tm, _, ts, _, _ = states[robot]
        grf = titf.lfoot_grf(tm, ts) + titf.rfoot_grf(tm, ts)
        torch.testing.assert_close(grf, titf.interaction_force(tm, ts))
        mg = titf.total_mass(tm) * 9.81
        assert bool(((grf > 0.3 * mg) & (grf < 3.0 * mg)).all()), (robot, grf, mg)
        assert bool(titf.check_lfoot_floor_collision(tm, ts).all()) and bool(titf.check_rfoot_floor_collision(tm, ts).all())
        assert not bool(titf.check_bad_collisions(tm, ts).any())
