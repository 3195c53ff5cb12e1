"""The port's jvrc_walk env against the JAX package's, on CPU.

Random draws are injected, not regenerated: the JAX env derives its task
draws from per-env PRNG keys; the tests replay that key schedule with
jax.random to get the same numbers and hand them to the port through
InjectedDraws. Actions come from numpy with a fixed seed.

Tolerances: observations and weighted reward components 1e-3 absolute
(O(1) values; a few control steps from a settled reset, where both engines
agree to ~1e-5 — far inside bench.py's cross-compiler gate of 5e-3 on
qpos); done flags and task state exactly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from learninghumanoidwalking_tpu.envs.jvrc_walk import JvrcWalkEnv as JaxJvrcWalkEnv
from learninghumanoidwalking_tpu.tasks import walking as jwalking
from learninghumanoidwalking_tpu_torch.envs.jvrc_walk import JvrcWalkEnv
from learninghumanoidwalking_tpu_torch.tasks import walking
from learninghumanoidwalking_tpu_torch.utils.seeding import InjectedDraws

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
