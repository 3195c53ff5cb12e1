"""The port's engine step (physics/batched.py ``engine_step_b`` /
``engine_forward_b``, with robots/pd.py's PD loop) and the cartpole env
against the JAX package's ``engine.step`` / ``engine.forward`` on the CPU.

Same states, gains and targets (made with numpy from a seed) go through both
packages; the cartpole env's reset draws are the JAX env's, injected.

Tolerances:
* cartpole (no contacts: smooth dynamics only): 1e-5 absolute on qpos,
  qvel, observations and reward terms (O(1) quantities, f32 rounding of two
  implementations of the same formulas over 5 control steps); done exactly;
  the same on a cartpole whose cart frame is turned off the world axes (the
  slide moves along its axis in the parent frame);
* jvrc_walk with both feet on the floor (8 contact slots, 4 active per
  env): 1e-5 relative to each field's largest magnitude on qacc and the
  contact forces (~120 rad/s^2 and ~125 N), the f32 agreement of 30
  projected Jacobi sweeps over the same dual system (measured 2.6e-6 and
  1.9e-6); qpos and qvel 1e-5 absolute; contact masks exactly.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learninghumanoidwalking_tpu.envs.cartpole import CartpoleEnv as JaxCartpoleEnv
from learninghumanoidwalking_tpu.models import jvrc as jax_jvrc
from learninghumanoidwalking_tpu.models.cartpole import cartpole_spec as jax_cartpole_spec
from learninghumanoidwalking_tpu.physics import engine as je
from learninghumanoidwalking_tpu.physics.model import default_dyn_params as jax_default_dyn_params
from learninghumanoidwalking_tpu.physics.spec import lower as jax_lower
from learninghumanoidwalking_tpu.robots import pd as jpd
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.models import jvrc
from learninghumanoidwalking_tpu_torch.models.cartpole import cartpole_spec
from learninghumanoidwalking_tpu_torch.physics import batched as tb
from learninghumanoidwalking_tpu_torch.physics import engine as te
from learninghumanoidwalking_tpu_torch.physics.model import default_dyn_params
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.robots import pd as tpd
from learninghumanoidwalking_tpu_torch.utils.seeding import InjectedDraws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)


def cartpole_reset_draws(keys) -> dict:
    """Every draw of the JAX cartpole env's reset, by env key."""
    draws = {"init.pole": [], "init.qpos": [], "init.qvel": []}
    for k in keys:
        k1, k2, k3, _ = jax.random.split(k, 4)
        draws["init.pole"].append(jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi))
        draws["init.qpos"].append(jax.random.uniform(k2, (2,), minval=-0.1, maxval=0.1))
        draws["init.qvel"].append(jax.random.uniform(k3, (2,), minval=-0.1, maxval=0.1))
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in draws.items()}


@pytest.fixture(scope="module")
def cartpoles():
    torch.backends.cuda.matmul.allow_tf32 = False
    return JaxCartpoleEnv(), make_env("cartpole", device="cpu")


def test_cartpole_reset_and_steps_match_jax(cartpoles):
    """Reset with the JAX draws injected, then 5 control steps of seeded
    actions (some past the +-0.8 clip)."""
    jenv, tenv = cartpoles
    n = 6
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    js = jax.vmap(jenv.reset)(keys)
    ts = tenv.reset_batch(n, InjectedDraws(cartpole_reset_draws(keys)))
    assert tenv.obs_mean is None and tenv.obs_size == jenv.obs_size == 5 and tenv.action_size == 1
    step = jax.jit(jax.vmap(jenv.step))
    actions = (np.random.default_rng(3).standard_normal((5, n, 1)) * 0.6).astype(np.float32)
    for t in range(6):
        for name in ("qpos", "qvel"):
            np.testing.assert_allclose(getattr(ts.physics, name).numpy(), np.asarray(getattr(js.physics, name)), rtol=0, atol=1e-5)
        for name in ("obs", "reward", "reward_components", "prev_action"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=0, atol=1e-5)
        assert ts.done.tolist() == np.asarray(js.done).tolist() and ts.steps.tolist() == np.asarray(js.steps).tolist()
        if t < 5:
            js = step(js, jnp.asarray(actions[t]))
            ts = tenv.step_batch(ts, torch.as_tensor(actions[t]))
    assert float(np.abs(actions).max()) > 0.8 and float(ts.reward.min()) > 0


def engine_runs_match(jm, tm, kp, kd):
    """4 engine steps (ctrl through the gear) and a forward from seeded
    states agree with the JAX engine's; returns the port's stepped state."""
    assert tm.ncon == jm.ncon == 0 and tm.nv == 2
    rng = np.random.default_rng(4)
    n = 5
    qpos = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    qvel = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    ctrl = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    jd = jax_default_dyn_params(jm, jnp.asarray(kp), jnp.asarray(kd))
    td = default_dyn_params(tm, kp, kd, n)

    def jax_run(q, v, u):
        s = je.make_state(jm, q, v)
        for _ in range(4):
            s = je.step(jm, jd, s, u, 0.005)
        return s, je.forward(jm, jd, je.make_state(jm, q, v), 0.005)

    jo, jf = jax.jit(jax.vmap(jax_run))(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl))
    ts = te.make_state(tm, torch.as_tensor(qpos), torch.as_tensor(qvel))
    tf = tb.engine_forward_b(tm, td, ts, 0.005)
    for _ in range(4):
        ts = tb.engine_step_b(tm, td, ts, torch.as_tensor(ctrl), 0.005)
    for name in ("qpos", "qvel", "qacc", "act_torque", "xpos", "xquat", "cvel", "time"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(jo, name)), rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("qacc", "xpos", "cvel"):
        np.testing.assert_allclose(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), rtol=1e-5, atol=1e-5, err_msg=name)
    assert tf.act_torque.abs().max() == 0 and ts.contact.force.shape == (n, 0, 3)
    return ts


def test_engine_step_and_forward_on_cartpole_match_jax(cartpoles):
    """engine_step_b (4 substeps of PD control through the gear) and
    engine_forward_b from seeded states: no contact slots."""
    jenv, tenv = cartpoles
    engine_runs_match(jenv.model, tenv.model, tenv.kp, tenv.kd)


def test_slide_in_a_turned_frame_matches_jax(cartpoles):
    """The cart frame turned off the world axes: the slide joint moves the
    cart along its axis in that frame (fk_b, the motion subspace and the
    engine step all take it so, as the JAX engine does)."""
    quat = np.array([0.9, 0.1, 0.3, 0.2])
    quat = tuple(float(x) for x in quat / np.linalg.norm(quat))
    turned = lambda spec: dataclasses.replace(spec, bodies=[dataclasses.replace(spec.bodies[0], quat=quat), *spec.bodies[1:]])
    tm = lower(turned(cartpole_spec()), device="cpu")
    ts = engine_runs_match(jax_lower(turned(jax_cartpole_spec())), tm, cartpoles[1].kp, cartpoles[1].kd)
    w, x, y, z = quat  # the slider's x axis in the world: the first column of the frame's rotation
    axis = torch.tensor([1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)])
    torch.testing.assert_close(ts.xpos[:, 1], ts.qpos[:, :1] * axis, rtol=0, atol=1e-6)


def test_engine_step_and_forward_on_jvrc_match_jax():
    """pd_substeps (3 substeps of engine_step_b toward seeded targets) and
    engine_forward_b on JVRC-1 standing 3 mm into the floor: both feet in
    contact, so the projected Jacobi solve carries the robot."""
    B = 2
    kp = np.array([200, 200, 200, 250, 80, 80] * 2, np.float32)
    kd = np.array([20, 20, 20, 25, 8, 8] * 2, np.float32)
    jm, tm = jax_lower(jax_jvrc.jvrc_spec()), lower(jvrc.jvrc_spec(), device="cpu")
    rng = np.random.default_rng(0)
    pose = np.deg2rad(np.asarray(jvrc.HALF_SITTING_POSE_DEG, np.float32))
    nominal = np.concatenate([[0, 0, jvrc.NOMINAL_HEIGHT - 0.003, 1, 0, 0, 0], pose]).astype(np.float32)
    qpos = np.tile(nominal[None], (B, 1))
    qpos[:, :2] += 0.01 * rng.standard_normal((B, 2)).astype(np.float32)
    qvel = (0.05 * rng.standard_normal((B, 18))).astype(np.float32)
    target = (pose[None] + 0.05 * rng.standard_normal((B, 12))).astype(np.float32)

    jd = jax_default_dyn_params(jm, jnp.asarray(kp), jnp.asarray(kd))
    js = jax.vmap(lambda q, v: je.make_state(jm, q, v))(jnp.asarray(qpos), jnp.asarray(qvel))
    run = jax.jit(jax.vmap(lambda s, t: (jpd.pd_substeps(jm, jd, s, t, 3, 0.001), je.forward(jm, jd, s, 0.001))))
    jo, jf = run(js, jnp.asarray(target))
    td = default_dyn_params(tm, kp, kd, B)
    ts = te.make_state(tm, torch.as_tensor(qpos), torch.as_tensor(qvel))
    to = tpd.pd_substeps(tm, td, ts, torch.as_tensor(target), 3, 0.001)
    tf = tb.engine_forward_b(tm, td, ts, 0.001)

    def rel_close(mine, theirs, name):
        theirs = np.asarray(theirs)
        err = float(np.abs(mine.numpy() - theirs).max())
        assert err <= 1e-5 * float(np.abs(theirs).max()), (name, err, float(np.abs(theirs).max()))

    for out, ref in ((to, jo), (tf, jf)):
        assert out.contact.mask.tolist() == np.asarray(ref.contact.mask).tolist()
        assert out.contact.mask.sum(1).tolist() == [4.0, 4.0]  # the heel corners of both feet
        rel_close(out.qacc, ref.qacc, "qacc")
        rel_close(out.contact.force, ref.contact.force, "force")
        assert float(out.contact.force[..., 0].sum(1).min()) > 50.0  # the floor carries the robot
    for name in ("qpos", "qvel"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to.act_torque.numpy(), np.asarray(jo.act_torque), rtol=1e-5, atol=1e-4)
    assert math.isclose(float(to.time[0]), 0.003, rel_tol=1e-6)
