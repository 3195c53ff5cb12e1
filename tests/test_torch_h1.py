"""The port's Unitree H1 slice against the JAX package, on the CPU: the
model lowering, the standing task, self-collision, the h1 and h1_walk envs
and H1's mirror matrices.

Inputs come from numpy with fixed seeds; the envs' random draws are the
JAX env's, replayed from its key schedule and injected (InjectedDraws;
helpers shared with test_torch_env.py). Tolerances: model arrays 1e-6,
integer tables exactly; standing reward terms 1e-6 (the same float32
formulas), done and self-collision flags exactly; env observations and
reward terms 1e-3 absolute (a few control steps from a settled reset, as
for jvrc_walk), done flags exactly, except in an env where the reference
is shown chaotic against a float64 run (see the env test); mirror
matrices exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learninghumanoidwalking_tpu.envs.h1_stand import H1StandEnv as JaxH1StandEnv
from learninghumanoidwalking_tpu.envs.h1_walk import H1WalkEnv as JaxH1WalkEnv
from learninghumanoidwalking_tpu.models import h1 as jax_h1
from learninghumanoidwalking_tpu.physics import engine as jengine
from learninghumanoidwalking_tpu.physics.spec import lower as jax_lower
from learninghumanoidwalking_tpu.rl import mirror as jmirror
from learninghumanoidwalking_tpu.tasks import standing as jstanding
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.models import h1
from learninghumanoidwalking_tpu_torch.physics import batched, engine
from learninghumanoidwalking_tpu_torch.physics import model as tmodel
from learninghumanoidwalking_tpu_torch.physics.model import tree_map
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.rl import mirror
from learninghumanoidwalking_tpu_torch.tasks import standing
from learninghumanoidwalking_tpu_torch.utils.seeding import InjectedDraws
from test_torch_env import _dyn_draws, _env_step_draws, _init_draws, _obs_noise_draws, _walking_reset_draws, _walking_step_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

JAX_ENVS = {"h1": JaxH1StandEnv, "h1_walk": JaxH1WalkEnv}
ATOL, SENS = 1e-3, 10.0


def test_h1_model_matches_jax():
    ref = jax_lower(jax_h1.h1_spec())
    got = lower(h1.h1_spec(), device="cpu")
    assert (got.nq, got.nv, got.nu, got.nbody, got.ncon) == (17, 16, 10, 13, 8)
    assert len(got.self_pairs) == 5
    for f in dataclasses.fields(got):
        mine, theirs = getattr(got, f.name), getattr(ref, f.name)
        if f.name in tmodel._STATIC_FIELDS:
            assert mine == theirs, f.name
        else:
            theirs, mine = np.asarray(theirs), mine.numpy()
            assert mine.dtype == np.float32 and mine.shape == theirs.shape, f.name
            np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-6, err_msg=f.name)
    assert h1.LEG_JOINTS == jax_h1.LEG_JOINTS and h1.NOMINAL_HEIGHT == jax_h1.NOMINAL_HEIGHT == 0.98


def test_standing_reward_and_done_match_jax():
    rng = np.random.default_rng(0)
    n = 256
    f = lambda *s, scale=1.0: (scale * rng.standard_normal((n, *s))).astype(np.float32)
    pose0 = np.asarray(jax_h1.HALF_SITTING_POSE, np.float32)
    args = dict(root_vel_local_xy=f(2, scale=0.5), yaw_vel=f(scale=0.5), root_height=0.98 + f(scale=0.3),
                head_offset_in_base_xy=f(2, scale=0.1), pose=pose0 + f(10, scale=0.3), torque=f(10, scale=60.0))
    ref = jax.vmap(lambda *a: jstanding.compute_reward(jnp.asarray(pose0), *a))(*map(jnp.asarray, args.values()))
    got = standing.compute_reward(torch.as_tensor(pose0), **{k: torch.as_tensor(v) for k, v in args.items()})
    assert got.shape == (n, 6) and standing.REWARD_NAMES == jstanding.REWARD_NAMES
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    selfcol = rng.random(n) < 0.2
    ref_done = jstanding.done(jnp.asarray(args["root_height"]), jnp.asarray(selfcol))
    got_done = standing.done(torch.as_tensor(args["root_height"]), torch.as_tensor(selfcol))
    assert 0 < int(got_done.sum()) < n
    np.testing.assert_array_equal(got_done.numpy(), np.asarray(ref_done))


def test_self_collision_matches_jax():
    """Seeded H1 poses, legs swung inwards far enough that some pairs
    overlap: the same body poses give the same flags."""
    model = lower(h1.h1_spec(), device="cpu")
    jmodel = jax_lower(jax_h1.h1_spec())
    rng = np.random.default_rng(1)
    n = 128
    qpos = np.tile(np.concatenate([[0, 0, 0.98, 1, 0, 0, 0], jax_h1.HALF_SITTING_POSE]).astype(np.float32), (n, 1))
    qpos[:, 7:] += rng.uniform(-0.6, 0.6, (n, 10)).astype(np.float32)
    qpos[:, [8, 13]] += np.array([-0.35, 0.35], np.float32) * rng.uniform(0, 1, (n, 1)).astype(np.float32)
    state = engine.make_state(model, torch.as_tensor(qpos), torch.zeros((n, model.nv)))
    got = engine.self_collision(model, state.xpos, state.xquat)
    ref = jax.vmap(lambda p, q: jengine.self_collision(jmodel, p, q))(jnp.asarray(state.xpos.numpy()), jnp.asarray(state.xquat.numpy()))
    assert 0 < int(got.sum()) < n
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module", params=["h1", "h1_walk"])
def env_pair(request):
    name = request.param
    return name, JAX_ENVS[name](), make_env(name, device="cpu")


def h1_reset_draws(jenv, keys):
    """Every draw of a JAX H1 env's reset_batch for the port, by env key."""
    k_dyn, k_noise, k_task, k_obs, _ = (jnp.stack(x) for x in zip(*[jax.random.split(k, 5) for k in keys]))
    draws = {**_dyn_draws(k_dyn, jenv.model), **_init_draws(k_noise, jenv.init_noise * np.pi / 180.0, jenv.model.nu),
             **_obs_noise_draws(k_obs, jenv.robot_state_len)}
    if isinstance(jenv, JaxH1WalkEnv):
        draws.update(_walking_reset_draws(k_task, jenv.period))
    return draws


def h1_step_draws(jenv, keys):
    """Every draw of a JAX H1 env's step_batch for the port, by env key."""
    draws = _env_step_draws(jenv, keys)
    if isinstance(jenv, JaxH1WalkEnv):
        k_task = jnp.stack([jax.random.split(k, 6)[0] for k in keys])
        draws.update(_walking_step_draws(k_task))
    return draws


def _chaotic(tenv, ts, actions, js_next, ts_next, envs) -> list:
    """Of ``envs`` (which disagree past the tolerance after a step from the
    same state), those where the reference itself leaves the float64
    solution: the port's plain physics run in float64 from the port's input
    state, and the JAX step's qpos / qvel distance from it is above the
    tolerance while the port's is at most SENS times the JAX one."""
    idx = torch.as_tensor(envs)
    pick = lambda tree: tree_map(lambda x: x[idx] if torch.is_tensor(x) and x.dim() > 0 and x.shape[0] == ts.obs.shape[0] else x, tree)
    to64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x
    target = tenv._pre_step(pick(ts), actions[idx])
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out64 = batched.pd_substeps_batched(tree_map(to64, tenv.model), tree_map(to64, pick(ts.dyn)), tree_map(to64, pick(ts.physics)),
                                            target.double(), tenv.frame_skip, tenv.sim_dt, reuse_interval=tenv.physics_reuse)
    finally:
        torch.set_default_dtype(prev)
    far = lambda a, b: (a.double() - b).abs().amax(1)
    e_jax = torch.maximum(far(torch.as_tensor(np.array(js_next.physics.qvel))[idx], out64.qvel),
                          far(torch.as_tensor(np.array(js_next.physics.qpos))[idx], out64.qpos))
    e_port = torch.maximum(far(ts_next.physics.qvel[idx], out64.qvel), far(ts_next.physics.qpos[idx], out64.qpos))
    return [e for e, ej, ep in zip(envs, e_jax.tolist(), e_port.tolist()) if ej > ATOL and ep <= SENS * ej]


def test_h1_env_reset_and_step_match_jax(env_pair):
    """Reset and 3 steps with the config's observation noise (motor_tau
    5.0 on the torque observations), dynamics randomization and
    perturbation wrenches, every draw injected. An env may leave the
    comparison (at most one of the six) only where the reference itself is
    chaotic there: its float32 step lands farther than the tolerance from a
    float64 run of the same step, and the port's lands no farther than SENS
    times that (_chaotic); from then on the two trajectories are different
    samples of one chaotic state and are not compared."""
    name, jenv, tenv = env_pair
    assert tenv.obs_size == jenv.obs_size == {"h1": 35, "h1_walk": 43}[name]
    assert tenv.include_torque_obs and tenv.robot_state_len == 35
    assert tenv.dynrand_interval == jenv.dynrand_interval == 20 and tenv.perturb_interval == jenv.perturb_interval == 200
    assert tenv.perturb_bodies == jenv.perturb_bodies and len(tenv.perturb_bodies) == 2
    np.testing.assert_array_equal(tenv.obs_noise_scale.numpy(), jenv.obs_noise_scale)
    np.testing.assert_allclose(tenv.obs_mean, jenv.obs_mean)
    np.testing.assert_allclose(tenv.obs_std, jenv.obs_std)
    n = 6
    keys = jax.random.split(jax.random.PRNGKey(21), n)
    js = jax.jit(jenv.reset_batch)(keys)
    ts = tenv.reset_batch(n, InjectedDraws(h1_reset_draws(jenv, keys)))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ts.dyn.body_mass.numpy(), np.asarray(js.dyn.body_mass), rtol=0, atol=1e-6)

    rng = np.random.default_rng(5)
    jstep = jax.jit(jenv.step_batch)
    live = list(range(n))
    for _ in range(3):
        actions = (0.2 * rng.standard_normal((n, 10))).astype(np.float32)
        draws = InjectedDraws(h1_step_draws(jenv, js.key))
        js_next = jstep(js, jnp.asarray(actions))
        ts_next = tenv.step_batch(ts, torch.tensor(actions), draws)
        err = np.abs(ts_next.obs.numpy() - np.asarray(js_next.obs)).max(1)
        off = [e for e in live if err[e] > ATOL]
        chaotic = _chaotic(tenv, ts, torch.tensor(actions), js_next, ts_next, off) if off else []
        assert chaotic == off, (off, chaotic)
        live = [e for e in live if e not in chaotic]
        js, ts = js_next, ts_next
        np.testing.assert_allclose(ts.obs.numpy()[live], np.asarray(js.obs)[live], rtol=0, atol=ATOL)
        np.testing.assert_allclose(ts.reward_components.numpy()[live], np.asarray(js.reward_components)[live], rtol=0, atol=ATOL)
        np.testing.assert_allclose(ts.reward.numpy()[live], np.asarray(js.reward)[live], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(ts.done.numpy()[live], np.asarray(js.done)[live])
        np.testing.assert_allclose(ts.dyn.xfrc.numpy(), np.asarray(js.dyn.xfrc), rtol=0, atol=1e-6)
    assert len(live) >= n - 1
    # the torque observations carry the applied torque
    assert float(ts.physics.act_torque.abs().max()) > 1.0


def test_h1_walk_mirror_matrices_match_jax():
    jenv, tenv = JaxH1WalkEnv(), make_env("h1_walk", device="cpu")
    assert tenv.mirrored_obs == jenv.mirrored_obs and tenv.mirrored_acts == jenv.mirrored_acts
    assert tenv.clock_inds == jenv.clock_inds == [35, 36]
    np.testing.assert_array_equal(
        mirror.obs_symmetry_matrix(tenv.mirrored_obs, tenv.clock_inds, tenv.history_len),
        jmirror.obs_symmetry_matrix(jenv.mirrored_obs, jenv.clock_inds, jenv.history_len),
    )
    np.testing.assert_array_equal(mirror.symmetry_matrix(tenv.mirrored_acts), jmirror.symmetry_matrix(jenv.mirrored_acts))
    # -0.1 stands for index 0 negated
    assert mirror.symmetry_matrix(tenv.mirrored_acts)[5, 0] == -1.0
