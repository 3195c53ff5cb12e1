"""The port's jvrc_walk, jvrc_step and jvrc_walk_rough envs against the JAX
package's, on CPU.

Random draws are injected, not regenerated: the JAX env derives its task
draws from per-env PRNG keys; the tests replay that key schedule with
jax.random to get the same numbers and hand them to the port through
InjectedDraws. Actions come from numpy with a fixed seed.

Tolerances: observations and weighted reward components 1e-3 absolute
(O(1) values; a few control steps from a settled reset, where both engines
agree to ~1e-5 — far inside bench.py's cross-compiler gate of 5e-3 on
qpos); done flags and task state exactly. The stepping task's sequences,
terrain and footstep plan bank are held exactly (the same float32 formulas
on the same inputs); the terrain of a whole env reset is held to 1e-6,
since it is placed at the feet that each package's forward kinematics put
there.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from learninghumanoidwalking_tpu.envs.jvrc_step import JvrcStepEnv as JaxJvrcStepEnv
from learninghumanoidwalking_tpu.envs.jvrc_walk import JvrcWalkEnv as JaxJvrcWalkEnv
from learninghumanoidwalking_tpu.envs.jvrc_walk_rough import JvrcWalkRoughEnv as JaxJvrcWalkRoughEnv
from learninghumanoidwalking_tpu.tasks import stepping as jstepping
from learninghumanoidwalking_tpu.tasks import walking as jwalking
from learninghumanoidwalking_tpu.utils.footstep_plans import plan_bank as jax_plan_bank
from learninghumanoidwalking_tpu_torch.envs.jvrc_step import JvrcStepEnv
from learninghumanoidwalking_tpu_torch.envs.jvrc_walk import JvrcWalkEnv
from learninghumanoidwalking_tpu_torch.envs.jvrc_walk_rough import JvrcWalkRoughEnv
from learninghumanoidwalking_tpu_torch.ops.substep_kernel import kernel_reuse
from learninghumanoidwalking_tpu_torch.tasks import stepping, walking
from learninghumanoidwalking_tpu_torch.utils.footstep_plans import plan_bank
from learninghumanoidwalking_tpu_torch.utils.seeding import InjectedDraws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

B = 6
STEPS = 3


def _mode_ref_draws(keys):
    """The three raw draws sample_mode_ref takes from each key."""

    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (
            jax.random.uniform(k1, (3,), minval=-1.0, maxval=1.0),
            jax.random.uniform(k2, (), minval=-0.5, maxval=0.5),
            jax.random.uniform(k3, (), minval=0.0, maxval=0.4),
        )

    s, i, f = jax.vmap(one)(keys)
    return {"task.standing_ref": np.asarray(s), "task.inplace_yaw": np.asarray(i), "task.forward_vx": np.asarray(f)}


def reset_draws(keys, period):
    """Draws of JAX _reset_pre -> walking.reset for each env key."""

    def one(k):
        _, _, k_task, _, _ = jax.random.split(k, 5)
        k1, k2, k3 = jax.random.split(k_task, 3)
        mode = jax.random.choice(k1, jnp.array([2, 1, 0]), p=jnp.array([0.6, 0.2, 0.2]))
        return mode, k2, jax.random.randint(k3, (), 0, period)

    mode, k2, phase = jax.vmap(one)(keys)
    return {"task.mode": np.asarray(mode), "task.phase": np.asarray(phase), **_mode_ref_draws(k2)}


def step_draws(keys):
    """Draws of JAX _post_step -> walking.step for each env key."""

    def one(k):
        k_task = jax.random.split(k, 6)[0]
        k1, k2, k3, _ = jax.random.split(k_task, 4)
        return jax.random.randint(k1, (), 0, 100), jax.random.randint(k2, (), 0, 200), k3

    s1, s2, k3 = jax.vmap(one)(keys)
    return {"task.switch1": np.asarray(s1), "task.switch2": np.asarray(s2), **_mode_ref_draws(k3)}


@pytest.fixture(scope="module")
def envs():
    return JaxJvrcWalkEnv(), JvrcWalkEnv(device="cpu")


def test_walking_task_matches_jax():
    """walking.reset / walking.step over many envs, so mode switches occur."""
    n, period = 4000, 88
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    ref = jax.vmap(lambda k: jwalking.reset(k, period))(keys)
    # walking.reset takes its key directly (no _reset_pre split here)
    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        mode = jax.random.choice(k1, jnp.array([2, 1, 0]), p=jnp.array([0.6, 0.2, 0.2]))
        return mode, k2, jax.random.randint(k3, (), 0, period)

    mode, k2, phase = jax.vmap(one)(keys)
    draws = {"task.mode": np.asarray(mode), "task.phase": np.asarray(phase), **_mode_ref_draws(k2)}
    mine = walking.reset(InjectedDraws(draws), n, period, "cpu")
    np.testing.assert_array_equal(mine.mode.numpy(), np.asarray(ref.mode))
    np.testing.assert_array_equal(mine.phase.numpy(), np.asarray(ref.phase))
    np.testing.assert_array_equal(mine.mode_ref.numpy(), np.asarray(ref.mode_ref))

    env = JaxJvrcWalkEnv()
    dbl = env.dbl_support
    skeys = jax.random.split(jax.random.PRNGKey(4), n)
    stepped = jax.vmap(lambda k, ts: jwalking.step(k, ts, period, dbl))(skeys, ref)

    def sone(k):
        k1, k2, k3, _ = jax.random.split(k, 4)
        return jax.random.randint(k1, (), 0, 100), jax.random.randint(k2, (), 0, 200), k3

    s1, s2, k3 = jax.vmap(sone)(skeys)
    sdraws = {"task.switch1": np.asarray(s1), "task.switch2": np.asarray(s2), **_mode_ref_draws(k3)}
    got = walking.step(InjectedDraws(sdraws), mine, period, torch.as_tensor(np.asarray(dbl)))
    assert np.sum(np.asarray(stepped.mode) != np.asarray(ref.mode)) > 10  # switches happened
    np.testing.assert_array_equal(got.mode.numpy(), np.asarray(stepped.mode))
    np.testing.assert_array_equal(got.phase.numpy(), np.asarray(stepped.phase))
    np.testing.assert_array_equal(got.mode_ref.numpy(), np.asarray(stepped.mode_ref))


def test_reset_and_step_match_jax(envs):
    jenv, tenv = envs
    assert tenv.obs_size == jenv.obs_size == 37
    assert tenv.physics_reuse == jenv.physics_reuse
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    js = jax.jit(jenv.reset_batch)(keys)
    ts = tenv.reset_batch(B, InjectedDraws(reset_draws(keys, jenv.period)))

    np.testing.assert_array_equal(ts.task.mode.numpy(), np.asarray(js.task.mode))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts.physics.qpos.numpy(), np.asarray(js.physics.qpos), rtol=0, atol=1e-4)

    rng = np.random.default_rng(0)
    jstep = jax.jit(jenv.step_batch)
    for _ in range(STEPS):
        actions = (0.2 * rng.standard_normal((B, 12))).astype(np.float32)
        draws = InjectedDraws(step_draws(js.key))
        js = jstep(js, jnp.asarray(actions))
        ts = tenv.step_batch(ts, torch.tensor(actions), draws)
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
        np.testing.assert_allclose(
            ts.reward_components.numpy(), np.asarray(js.reward_components), rtol=0, atol=1e-3
        )
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
        np.testing.assert_array_equal(ts.steps.numpy(), np.asarray(js.steps))


def test_nonfinite_physics_terminates(envs):
    """A NaN state is flagged done and its observation / reward sanitized."""
    _, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    ts = tenv.reset_batch(2, InjectedDraws(reset_draws(keys, tenv.period)))
    ts.physics.qvel[1, 0] = float("nan")
    out = tenv.step_batch(ts, torch.zeros((2, 12)), InjectedDraws(step_draws(keys)))
    assert not bool(out.done[0]) and bool(out.done[1])
    assert torch.isfinite(out.obs).all() and torch.isfinite(out.reward).all()
    assert not torch.isfinite(out.physics.qpos[1]).all()


def test_domain_randomization_draws_match_jax(tmp_path):
    """_sample_dynamics / _sample_perturbation with the JAX draws injected
    (jvrc_walk ships them off; a config turns them on here)."""
    import json

    import yaml

    extra = {
        "dynamics_randomization": {"enable": True, "interval": 0.5},
        "perturbation": {"enable": True, "interval": 2.0, "force_magnitude": 30.0, "torque_magnitude": 5.0,
                         "bodies": ["PELVIS_S", "R_ANKLE_P_S"]},
    }
    from learninghumanoidwalking_tpu_torch.envs import humanoid as th

    base = json.load(open(f"{th.CONFIG_DIR}/jvrc_base.json"))
    (tmp_path / "c.json").write_text(json.dumps({**base, **extra}))
    (tmp_path / "c.yaml").write_text(yaml.safe_dump({k: v for k, v in {**base, **extra}.items() if not k.startswith("_")}))
    jenv = JaxJvrcWalkEnv(str(tmp_path / "c.yaml"))
    tenv = JvrcWalkEnv(str(tmp_path / "c.json"), device="cpu")
    n = 5
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    ref = jax.vmap(jenv._sample_dynamics)(keys)

    def dyn_draws(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        m = jenv.model
        return (jax.random.uniform(k1, (m.nv,), minval=0.0, maxval=2.0),
                jax.random.uniform(k2, (m.nv,), minval=0.02, maxval=2.0),
                jax.random.uniform(k3, (m.nbody,), minval=0.95, maxval=1.05),
                jax.random.uniform(k4, (m.nbody, 3), minval=-0.01, maxval=0.01))

    fl, dp, ms, ip = map(np.asarray, jax.vmap(dyn_draws)(keys))
    got = tenv._sample_dynamics(InjectedDraws({"dyn.frictionloss": fl, "dyn.damping": dp, "dyn.mass_scale": ms, "dyn.ipos": ip}), n)
    for f in ("dof_damping", "dof_frictionloss", "body_mass", "body_ipos", "xfrc", "kp", "kd", "bemf_gain"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), rtol=0, atol=1e-6, err_msg=f)

    pref = jax.vmap(jenv._sample_perturbation)(keys, ref)

    def pert_draws(k):
        ks = jax.random.split(k, len(jenv.perturb_bodies) + 1)
        out = []
        for i in range(len(jenv.perturb_bodies)):
            kf, kt, kz = jax.random.split(ks[i], 3)
            out += [jax.random.uniform(kf, (3,), minval=-30.0, maxval=30.0),
                    jax.random.uniform(kt, (3,), minval=-5.0, maxval=5.0),
                    1 - jax.random.bernoulli(kz, 0.5).astype(jnp.int32)]
        return out

    pd = [np.asarray(x) for x in jax.vmap(pert_draws)(keys)]
    draws = {}
    for i in range(len(jenv.perturb_bodies)):
        draws[f"pert.force{i}"], draws[f"pert.torque{i}"], draws[f"pert.keep{i}"] = pd[3 * i : 3 * i + 3]
    pgot = tenv._sample_perturbation(InjectedDraws(draws), got)
    assert np.abs(np.asarray(pref.xfrc)).max() > 0
    np.testing.assert_allclose(pgot.xfrc.numpy(), np.asarray(pref.xfrc), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# terrain envs: jvrc_step (stepping stones, K2) and jvrc_walk_rough (K3)
# ---------------------------------------------------------------------------


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _walking_reset_draws(task_keys, period):
    """Draws of JAX walking.reset for each task key."""

    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        mode = jax.random.choice(k1, jnp.array([2, 1, 0]), p=jnp.array([0.6, 0.2, 0.2]))
        return mode, k2, jax.random.randint(k3, (), 0, period)

    mode, k2, phase = jax.vmap(one)(task_keys)
    return {"task.mode": np.asarray(mode), "task.phase": np.asarray(phase), **_mode_ref_draws(k2)}


def _walking_step_draws(task_keys):
    """Draws of JAX walking.step for each task key."""

    def one(k):
        k1, k2, k3, _ = jax.random.split(k, 4)
        return jax.random.randint(k1, (), 0, 100), jax.random.randint(k2, (), 0, 200), k3

    s1, s2, k3 = jax.vmap(one)(task_keys)
    return {"task.switch1": np.asarray(s1), "task.switch2": np.asarray(s2), **_mode_ref_draws(k3)}


def _dyn_draws(keys, m):
    """Draws of JAX HumanoidEnv._sample_dynamics for each key."""

    def one(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        return {
            "dyn.frictionloss": jax.random.uniform(k1, (m.nv,), minval=0.0, maxval=2.0),
            "dyn.damping": jax.random.uniform(k2, (m.nv,), minval=0.02, maxval=2.0),
            "dyn.mass_scale": jax.random.uniform(k3, (m.nbody,), minval=0.95, maxval=1.05),
            "dyn.ipos": jax.random.uniform(k4, (m.nbody, 3), minval=-0.01, maxval=0.01),
        }

    return _np(jax.vmap(one)(keys))


def _init_draws(keys, c, nu):
    """Draws of the JAX initial-pose noise for each key."""

    def one(k):
        kz, kr, kj = jax.random.split(k, 3)
        return {
            "init.height": jax.random.uniform(kz, (), minval=0.0, maxval=0.02),
            "init.roll_pitch": jax.random.uniform(kr, (2,), minval=-c, maxval=c),
            "init.joints": jax.random.uniform(kj, (nu,), minval=-c, maxval=c),
        }

    return _np(jax.vmap(one)(keys))


def _obs_noise_draws(keys, n):
    return {"obs.noise": np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,), minval=-1.0, maxval=1.0))(keys))}


def _stepping_reset_draws(task_keys, nplans):
    """Draws of JAX stepping.reset for each task key: one named draw per use
    of a key (the JAX branches of make_sequence share k0)."""

    def one(k):
        k_mode, k_phase, k_seq = jax.random.split(k, 3)
        k0, k1, k2 = jax.random.split(k_seq, 3)
        ka, kb = jax.random.split(k0)
        modes = jnp.array([jstepping.CURVED, jstepping.STANDING, jstepping.BACKWARD, jstepping.LATERAL, jstepping.FORWARD])
        return {
            "step.mode": jax.random.choice(k_mode, modes, p=jnp.array([0.15, 0.05, 0.2, 0.3, 0.3])),
            "step.phase_flip": jax.random.bernoulli(k_phase, 0.5).astype(jnp.int32),
            "step.height_sign": jax.random.bernoulli(k1, 0.5).astype(jnp.int32),
            "step.inplace_size": jax.random.uniform(k2, (), minval=-0.05, maxval=0.05),
            "step.first_y": jax.random.uniform(ka, (), minval=0.095, maxval=0.105),
            "step.c": jax.random.randint(kb, (), 2, 4),
            "step.lateral_side": jax.random.bernoulli(k0, 0.5).astype(jnp.int32),
            "step.plan": jax.random.randint(k0, (), 0, nplans),
        }

    return _np(jax.vmap(one)(task_keys))


def _env_reset_draws(jenv, keys):
    """Every draw of a JAX env's reset_batch for the port, by env key."""
    k_dyn, k_noise, k_task, k_obs, _ = (jnp.stack(x) for x in zip(*[jax.random.split(k, 5) for k in keys]))
    draws = {}
    if jenv.dynrand_interval:
        draws.update(_dyn_draws(k_dyn, jenv.model))
    if jenv.init_noise:
        draws.update(_init_draws(k_noise, jenv.init_noise * np.pi / 180.0, jenv.model.nu))
    if jenv.obs_noise_enabled:
        draws.update(_obs_noise_draws(k_obs, jenv.robot_state_len))
    if isinstance(jenv, JaxJvrcStepEnv):
        draws.update(_stepping_reset_draws(k_task, jenv.plans.shape[0]))
    else:
        k1, k2 = (jnp.stack(x) for x in zip(*[jax.random.split(k) for k in k_task]))
        draws.update(_walking_reset_draws(k1, jenv.period))
        draws["hfield"] = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (16, 16), minval=0.0, maxval=0.035))(k2))
    return draws


def _env_step_draws(jenv, keys):
    """Every draw of a JAX env's step_batch for the port, by env key."""
    k_task, k_obs, k_dyn, k_pert, k_ev, _ = (jnp.stack(x) for x in zip(*[jax.random.split(k, 6) for k in keys]))
    ev1, ev2, _, _ = (jnp.stack(x) for x in zip(*[jax.random.split(k, 4) for k in k_ev]))
    draws = {}
    if jenv.obs_noise_enabled:
        draws.update(_obs_noise_draws(k_obs, jenv.robot_state_len))
    if jenv.dynrand_interval:
        draws["dyn.event"] = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, jenv.dynrand_interval))(ev1))
        draws.update(_dyn_draws(k_dyn, jenv.model))
    if jenv.perturb_interval and jenv.perturb_bodies:
        draws["pert.event"] = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, jenv.perturb_interval))(ev2))

        def pert(k):
            ks = jax.random.split(k, len(jenv.perturb_bodies) + 1)
            out = {}
            for i in range(len(jenv.perturb_bodies)):
                kf, kt, kz = jax.random.split(ks[i], 3)
                out[f"pert.force{i}"] = jax.random.uniform(kf, (3,), minval=-jenv.perturb_force, maxval=jenv.perturb_force)
                out[f"pert.torque{i}"] = jax.random.uniform(kt, (3,), minval=-jenv.perturb_torque, maxval=jenv.perturb_torque)
                out[f"pert.keep{i}"] = 1 - jax.random.bernoulli(kz, 0.5).astype(jnp.int32)
            return out

        draws.update(_np(jax.vmap(pert)(k_pert)))
    if isinstance(jenv, JaxJvrcWalkRoughEnv):
        k1, k2, k3 = (jnp.stack(x) for x in zip(*[jax.random.split(k, 3) for k in k_task]))
        draws.update(_walking_step_draws(k1))
        draws["hfield.rejitter"] = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 200))(k2))
        draws["hfield"] = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (16, 16), minval=0.0, maxval=0.035))(k3))
    return draws


def _assert_terrain(tt, jt, exact):
    for f in ("pos", "size", "yaw", "floor_z", "hfield", "hfield_x0y0", "hfield_cell"):
        mine, ref = getattr(tt, f), getattr(jt, f)
        assert (mine is None) == (ref is None), f
        if mine is None:
            continue
        if exact:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref), err_msg=f)
        else:
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("name", ["jvrc_step", "jvrc_walk_rough"])
def test_terrain_env_reset_and_step_match_jax(name):
    """Reset at training iteration 11000 (full stair height for jvrc_step)
    and 3 steps, with every JAX draw injected: terrain, task state, obs,
    reward terms and done."""
    jenv, tenv = {
        "jvrc_step": (JaxJvrcStepEnv, JvrcStepEnv),
        "jvrc_walk_rough": (JaxJvrcWalkRoughEnv, JvrcWalkRoughEnv),
    }[name]
    jenv, tenv = jenv(), tenv(device="cpu")
    assert tenv.obs_size == jenv.obs_size == (39 if name == "jvrc_step" else 37)
    n, itr = 8, 11000
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    js = jax.jit(jenv.reset_batch)(keys, jnp.full((n,), itr, jnp.int32))
    ts = tenv.reset_batch(n, InjectedDraws(_env_reset_draws(jenv, keys)), itr)
    # both step on terrain at R=1 (the port's wrapper pins it)
    assert jenv.has_terrain and kernel_reuse(tenv._terrain(ts.task), tenv.physics_reuse) == jenv.physics_reuse == 1
    _assert_terrain(tenv._terrain(ts.task), jax.vmap(jenv._terrain)(js.task), exact=name != "jvrc_step")
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
    if name == "jvrc_step":
        np.testing.assert_array_equal(ts.task.mode.numpy(), np.asarray(js.task.mode))
        np.testing.assert_array_equal(ts.task.seq_len.numpy(), np.asarray(js.task.seq_len))
        assert len(set(ts.task.mode.tolist())) >= 3  # several stepping modes
    else:
        np.testing.assert_array_equal(ts.task.walk.mode.numpy(), np.asarray(js.task.walk.mode))

    rng = np.random.default_rng(1)
    jstep = jax.jit(jenv.step_batch)
    for _ in range(STEPS):
        actions = (0.2 * rng.standard_normal((n, 12))).astype(np.float32)
        draws = InjectedDraws(_env_step_draws(jenv, js.key))
        js = jstep(js, jnp.asarray(actions))
        ts = tenv.step_batch(ts, torch.tensor(actions), draws)
        _assert_terrain(tenv._terrain(ts.task), jax.vmap(jenv._terrain)(js.task), exact=name != "jvrc_step")
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
        np.testing.assert_allclose(ts.reward_components.numpy(), np.asarray(js.reward_components), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
        np.testing.assert_allclose(ts.dyn.xfrc.numpy(), np.asarray(js.dyn.xfrc), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ts.dyn.body_mass.numpy(), np.asarray(js.dyn.body_mass), rtol=0, atol=1e-6)


def test_plan_bank_matches_jax():
    plans, lengths = plan_bank()
    jplans, jlengths = jax_plan_bank()
    np.testing.assert_array_equal(plans, jplans)
    np.testing.assert_array_equal(lengths, jlengths)


def test_stepping_sequences_and_terrain_match_jax():
    """make_sequence over all six modes and four training iterations and
    make_terrain exactly, transform_sequence to 1e-6; the FORWARD stair
    height follows the iteration (0 before 3000, 0.1 from 11000 on)."""
    n, period = 240, 88
    plans, lengths = jax_plan_bank()
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    mode = np.arange(n) % 6
    phase = np.where(np.arange(n) % 4 < 2, 0, period // 2)
    iteration = np.array([0, 5000, 11000, 20000])[(np.arange(n) // 6) % 4]
    ref_seq, ref_len = jax.vmap(
        lambda k, m, p, i: jstepping.make_sequence(k, m, p, period, i, jnp.asarray(plans), jnp.asarray(lengths))
    )(keys, jnp.asarray(mode), jnp.asarray(phase), jnp.asarray(iteration, jnp.int32))

    def seq_draws(k):  # make_sequence's draws from its own key (no reset split)
        k0, k1, k2 = jax.random.split(k, 3)
        ka, kb = jax.random.split(k0)
        return {
            "step.height_sign": jax.random.bernoulli(k1, 0.5).astype(jnp.int32),
            "step.inplace_size": jax.random.uniform(k2, (), minval=-0.05, maxval=0.05),
            "step.first_y": jax.random.uniform(ka, (), minval=0.095, maxval=0.105),
            "step.c": jax.random.randint(kb, (), 2, 4),
            "step.lateral_side": jax.random.bernoulli(k0, 0.5).astype(jnp.int32),
            "step.plan": jax.random.randint(k0, (), 0, plans.shape[0]),
        }

    seq, length = stepping.make_sequence(
        InjectedDraws(_np(jax.vmap(seq_draws)(keys))), torch.tensor(mode), torch.tensor(phase), period,
        torch.tensor(iteration), torch.tensor(plans), torch.tensor(lengths, dtype=torch.int64),
    )
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref_seq))
    np.testing.assert_array_equal(length.numpy(), np.asarray(ref_len))
    fwd = mode == stepping.FORWARD
    expected_h = np.clip((iteration - 3000) / 8000, 0, 1) * 0.1
    np.testing.assert_allclose(np.abs(np.diff(seq.numpy()[fwd, :19, 2], axis=1)).max(1), expected_h[fwd], atol=1e-6)

    rng = np.random.default_rng(3)
    lfoot, rfoot = (rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32) for _ in range(2))
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ref_world = jax.vmap(jstepping.transform_sequence)(ref_seq, jnp.asarray(lfoot), jnp.asarray(rfoot), jnp.asarray(yaw))
    world = stepping.transform_sequence(seq, torch.tensor(lfoot), torch.tensor(rfoot), torch.tensor(yaw))
    # XLA may fuse the rotation into FMAs: one rounding apart on O(1) values
    np.testing.assert_allclose(world.numpy(), np.asarray(ref_world), rtol=0, atol=1e-6)
    ref_terrain = jax.vmap(jstepping.make_terrain)(ref_world, ref_len, jnp.asarray(mode))
    terrain = stepping.make_terrain(torch.tensor(np.asarray(ref_world)), length, torch.tensor(mode))
    _assert_terrain(terrain, ref_terrain, exact=True)


def test_stair_curriculum_follows_reset_iteration():
    """reset_batch's iteration sets the FORWARD stair height of jvrc_step."""
    tenv = JvrcStepEnv(device="cpu")
    n = 4
    draws = {
        "step.mode": np.full(n, stepping.FORWARD), "step.phase_flip": np.ones(n, int), "step.height_sign": np.ones(n, int),
        "step.inplace_size": np.zeros(n, np.float32), "step.first_y": np.full(n, 0.1, np.float32), "step.c": np.full(n, 2),
        "step.lateral_side": np.ones(n, int), "step.plan": np.zeros(n, int),
    }
    for itr, h in ((0, 0.0), (3000, 0.0), (7000, 0.05), (11000, 0.1), (50000, 0.1)):
        ts = tenv.reset_batch(n, InjectedDraws(draws), itr)
        z = ts.task.sequence[:, :19, 2].numpy()
        np.testing.assert_allclose(np.diff(z, axis=1).max(1), h, atol=1e-6)
        assert np.all(tenv._terrain(ts.task).floor_z.numpy() == -2.0)


# ---------------------------------------------------------------------------
# jvrc_walk with the learned motor model, PD-gain and back-EMF randomization
# ---------------------------------------------------------------------------


def _actuator_draws(keys, k, nu):
    """Draws of the JAX _post_step's pdrand_k and sim_bemf events per env key."""

    def one(key):
        k_ev = jax.random.split(key, 6)[4]
        _, _, ev3, ev4 = jax.random.split(k_ev, 4)
        kb1, kb2 = jax.random.split(ev3)
        return {
            "pd.kp_scale": jax.random.uniform(ev3, (nu,), minval=1 - k, maxval=1 + k),
            "pd.kd_scale": jax.random.uniform(ev4, (nu,), minval=1 - k, maxval=1 + k),
            "bemf.event": jax.random.randint(kb1, (), 0, 10),
            "bemf.gain": jax.random.uniform(kb2, (nu,), minval=5.0, maxval=40.0),
        }

    return _np(jax.vmap(one)(keys))


def test_motor_env_reset_and_step_match_jax(tmp_path):
    """jvrc_walk with motor_dynamics, pdrand_k and sim_bemf on, against the
    JAX env reading the same values from a YAML (physics at R=1 on both
    sides), the JAX motor weights carried over: reset and 3 steps with
    every draw injected, then 2 more steps.

    With the motor hook on, a back-EMF gain of U(5, 40) makes the
    reference unstable: the hook applies the last pushed torque, damping
    term included, one substep late on odd counts, and the env's joint
    velocities grow to the 1e4 clamp within about two control steps. The
    keys (seed 20) give one back-EMF event in the first four steps, in env
    2 after step 3, so steps 1-3 compare every env; steps 4-5 compare the
    other envs and show both packages blowing up env 2 alike."""
    import json

    import yaml

    from learninghumanoidwalking_tpu_torch.envs import humanoid as th
    from learninghumanoidwalking_tpu_torch.rl import convert

    cfg = json.load(open(f"{th.CONFIG_DIR}/jvrc_motor.json"))
    cfg = {k: v for k, v in cfg.items() if not k.startswith("_")}
    cfg.update(sim_bemf=True, physics_reuse_interval=1)
    (tmp_path / "m.json").write_text(json.dumps(cfg))
    (tmp_path / "m.yaml").write_text(yaml.safe_dump(cfg))
    jenv = JaxJvrcWalkEnv(str(tmp_path / "m.yaml"))
    tenv = JvrcWalkEnv(str(tmp_path / "m.json"), device="cpu")
    assert jenv.motor_enabled and tenv.motor_enabled and jenv.pdrand_k == tenv.pdrand_k == 0.1
    assert jenv.sim_bemf and tenv.sim_bemf and jenv.physics_reuse == 1
    tenv.motor_params = convert.motor_params({k: np.asarray(v) for k, v in jenv.motor_params.items()})

    n = 4
    keys = jax.random.split(jax.random.PRNGKey(20), n)
    js = jax.jit(jenv.reset_batch)(keys)
    ts = tenv.reset_batch(n, InjectedDraws(reset_draws(keys, jenv.period)))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ts.motor.count.numpy(), np.zeros(n, np.int32))

    rng = np.random.default_rng(2)
    jstep = jax.jit(jenv.step_batch)
    events = []
    for step in range(5):
        actions = (0.2 * rng.standard_normal((n, 12))).astype(np.float32)
        act_draws = _actuator_draws(js.key, 0.1, 12)
        events.append(act_draws["bemf.event"] == 0)
        draws = InjectedDraws({**step_draws(js.key), **act_draws})
        js = jstep(js, jnp.asarray(actions))
        ts = tenv.step_batch(ts, torch.tensor(actions), draws)
        np.testing.assert_array_equal(ts.motor.count.numpy(), np.asarray(js.motor.count))
        np.testing.assert_array_equal(ts.motor.count.numpy(), np.full(n, 25 * (step + 1)))
        for f in ("kp", "kd", "bemf_gain"):
            np.testing.assert_allclose(getattr(ts.dyn, f).numpy(), np.asarray(getattr(js.dyn, f)), rtol=0, atol=1e-6, err_msg=f)
        envs = slice(None) if step < 3 else [0, 1, 3]
        np.testing.assert_allclose(ts.obs.numpy()[envs], np.asarray(js.obs)[envs], rtol=0, atol=1e-3)
        np.testing.assert_allclose(
            ts.reward_components.numpy()[envs], np.asarray(js.reward_components)[envs], rtol=0, atol=1e-3
        )
        np.testing.assert_array_equal(ts.done.numpy()[envs], np.asarray(js.done)[envs])
    assert [e.tolist() for e in events[:4]] == [[False] * 4, [False] * 4, [False, False, True, False], [False] * 4]
    assert float(np.abs(np.asarray(js.dyn.bemf_gain)[2]).min()) >= 5.0
    assert float(ts.physics.qvel[2].abs().max()) > 100 and float(np.abs(np.asarray(js.physics.qvel)[2]).max()) > 100
