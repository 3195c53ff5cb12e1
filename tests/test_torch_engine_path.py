"""The port's engine path against the JAX package's, on the CPU: the envs'
``reset``/``step`` (one ``engine_step_b`` at a time through robots/pd.py
``pd_substeps`` or robots/motor.py ``pd_substeps_motor``) against
``jax.vmap`` of the JAX envs' single-env ``reset``/``step`` (one
``engine.step`` at a time), the motor hook's PD loop, cartpole's pair, and
the contact-behaviour tool against the JAX script's settle.

Random draws are the JAX envs', replayed from their key schedules and
injected (InjectedDraws; the helpers of test_torch_env.py and
test_torch_h1.py). Actions come from numpy with fixed seeds.

Tolerances:
* reset and 2 control steps at B=4 of jvrc_walk, jvrc_step (at training
  iteration 11000: full stair height), jvrc_walk_rough, h1 and jvrc_walk
  with envs/configs/jvrc_motor.json: observations and weighted reward
  components 1e-3 absolute, qpos 5e-3 absolute (bench.py's cross-compiler
  gate), done flags exactly, motor counts exactly (test_torch_env.py's
  rule: a few control steps from a settled reset);
* pd_substeps_motor, 5 substeps from the same state, histories and counts
  (warmup, its last slot, both push parities): 1e-5 relative to each
  field's largest magnitude on qpos, qvel, qacc and the histories, counts
  exactly (as test_torch_cartpole.py holds pd_substeps);
* the tool's settle_env against the JAX engine path's settle of one env
  for 0.2 s under zero action, the same draws injected: equal active
  contact counts, root z within 2e-3 m, per-foot GRF within 2% of the JAX
  value (bench.py's settled gates); its MuJoCo readings print the JAX
  script's line;
* cartpole's reset and 3 steps: 1e-5 absolute (test_torch_cartpole.py).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from learninghumanoidwalking_tpu.envs.h1_stand import H1StandEnv as JaxH1StandEnv
from learninghumanoidwalking_tpu.envs.jvrc_step import JvrcStepEnv as JaxJvrcStepEnv
from learninghumanoidwalking_tpu.envs.jvrc_walk import JvrcWalkEnv as JaxJvrcWalkEnv
from learninghumanoidwalking_tpu.envs.jvrc_walk_rough import JvrcWalkRoughEnv as JaxJvrcWalkRoughEnv
from learninghumanoidwalking_tpu.models import jvrc as jax_jvrc
from learninghumanoidwalking_tpu.physics import engine as je
from learninghumanoidwalking_tpu.physics.model import default_dyn_params as jax_default_dyn_params
from learninghumanoidwalking_tpu.physics.spec import lower as jax_lower
from learninghumanoidwalking_tpu.robots import motor as jmotor
from learninghumanoidwalking_tpu_torch import contact_behavior
from learninghumanoidwalking_tpu_torch.envs import humanoid as th
from learninghumanoidwalking_tpu_torch.envs.base import Env
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.models import jvrc
from learninghumanoidwalking_tpu_torch.physics import engine as te
from learninghumanoidwalking_tpu_torch.physics.model import default_dyn_params
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.rl import convert
from learninghumanoidwalking_tpu_torch.robots import motor
from learninghumanoidwalking_tpu_torch.utils.seeding import Draws, InjectedDraws
from test_torch_cartpole import cartpole_reset_draws
from test_torch_env import _actuator_draws, _env_reset_draws, _env_step_draws, reset_draws, step_draws
from test_torch_h1 import h1_reset_draws, h1_step_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

B = 4
STEPS = 2
MOTOR_JSON = f"{th.CONFIG_DIR}/jvrc_motor.json"
ITERATION = {"jvrc_step": 11000}


def _motor_env_pair(tmp_dir):
    """jvrc_walk with the motor config: the JAX env reads the same values
    from a YAML, and its motor weights are carried over to the port."""
    cfg = {k: v for k, v in json.load(open(MOTOR_JSON)).items() if not k.startswith("_")}
    (tmp_dir / "m.yaml").write_text(yaml.safe_dump(cfg))
    jenv = JaxJvrcWalkEnv(str(tmp_dir / "m.yaml"))
    tenv = make_env("jvrc_walk", path_to_json=MOTOR_JSON, device="cpu")
    tenv.motor_params = convert.motor_params({k: np.asarray(v) for k, v in jenv.motor_params.items()})
    return jenv, tenv


@pytest.fixture(scope="module", params=["jvrc_walk", "jvrc_step", "jvrc_walk_rough", "h1", "jvrc_walk_motor"])
def engine_pair(request, tmp_path_factory):
    """(name, JAX env, port env, jitted vmapped JAX reset, jitted vmapped JAX step)."""
    name = request.param
    if name == "jvrc_walk_motor":
        jenv, tenv = _motor_env_pair(tmp_path_factory.mktemp("motor"))
    else:
        jax_cls = {"jvrc_walk": JaxJvrcWalkEnv, "jvrc_step": JaxJvrcStepEnv, "jvrc_walk_rough": JaxJvrcWalkRoughEnv,
                   "h1": JaxH1StandEnv}[name]
        jenv, tenv = jax_cls(), make_env(name, device="cpu")
    itr = ITERATION.get(name)
    reset = jax.jit(jax.vmap(functools.partial(jenv.reset, iteration=None if itr is None else jnp.int32(itr))))
    return name, jenv, tenv, reset, jax.jit(jax.vmap(jenv.step))


def _reset_draws(name, jenv, keys):
    """Every draw of each env's JAX reset, by env key."""
    if name == "h1":
        return h1_reset_draws(jenv, keys)
    if name in ("jvrc_walk", "jvrc_walk_motor"):  # the walking task takes the task key whole
        return reset_draws(keys, jenv.period)
    return _env_reset_draws(jenv, keys)


def _step_draws(name, jenv, keys):
    """Every draw of one JAX control step of each env, by env key."""
    if name == "h1":
        return h1_step_draws(jenv, keys)
    draws = _env_step_draws(jenv, keys)
    if name in ("jvrc_walk", "jvrc_walk_motor"):  # the walking task's own draws
        draws.update(step_draws(keys))
    if jenv.pdrand_k:
        draws.update(_actuator_draws(keys, jenv.pdrand_k, jenv.model.nu))
    return draws


def _assert_states_match(ts, js):
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts.reward_components.numpy(), np.asarray(js.reward_components), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts.physics.qpos.numpy(), np.asarray(js.physics.qpos), rtol=0, atol=5e-3)
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    if ts.motor is not None:
        np.testing.assert_array_equal(ts.motor.count.numpy(), np.asarray(js.motor.count))


def test_engine_path_reset_and_step_match_jax(engine_pair):
    """reset, then 2 control steps of seeded actions, with every JAX draw
    injected, against jax.vmap of the JAX env's reset and step."""
    name, jenv, tenv, jreset, jstep = engine_pair
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    js = jreset(keys)
    ts = tenv.reset(B, InjectedDraws(_reset_draws(name, jenv, keys)), ITERATION.get(name))
    _assert_states_match(ts, js)
    rng = np.random.default_rng(8)
    for _ in range(STEPS):
        actions = (0.2 * rng.standard_normal((B, tenv.action_size))).astype(np.float32)
        draws = InjectedDraws(_step_draws(name, jenv, js.key))
        js = jstep(js, jnp.asarray(actions))
        ts = tenv.step(ts, torch.as_tensor(actions), draws)
        _assert_states_match(ts, js)
    if name == "jvrc_walk_motor":
        assert ts.motor.count.dtype == torch.int32 and ts.motor.count.tolist() == [2 * tenv.frame_skip] * B
    if name in ("jvrc_step", "jvrc_walk_rough"):  # the terrain carries the feet
        assert float(ts.physics.contact.mask.sum()) > 0 and tenv._terrain(ts.task) is not None


def test_pd_substeps_motor_matches_jax():
    """pd_substeps_motor (5 substeps of engine_step_b with the hook) from
    JVRC-1 standing 3 mm into the floor with seeded histories, counts 0,
    24, 25 and 26 (warmup, the last warmup substep, both push parities),
    seeded nets of std 0.3 (an MLP term of O(10%) of the torque) and
    back-EMF gains, against the JAX loop."""
    jm, tm = jax_lower(jax_jvrc.jvrc_spec()), lower(jvrc.jvrc_spec(), device="cpu")
    rng = np.random.default_rng(9)
    kp = np.array([200, 200, 200, 250, 80, 80] * 2, np.float32)
    kd = np.array([20, 20, 20, 25, 8, 8] * 2, np.float32)
    pose = np.deg2rad(np.asarray(jvrc.HALF_SITTING_POSE_DEG, np.float32))
    nominal = np.concatenate([[0, 0, jvrc.NOMINAL_HEIGHT - 0.003, 1, 0, 0, 0], pose]).astype(np.float32)
    qpos = np.tile(nominal[None], (B, 1))
    qvel = (0.05 * rng.standard_normal((B, 18))).astype(np.float32)
    target = (pose[None] + 0.05 * rng.standard_normal((B, 12))).astype(np.float32)
    bemf = rng.uniform(0.0, 2.0, (B, 12)).astype(np.float32)
    qdot_hist = (0.1 * rng.standard_normal((B, motor.HIST_LEN, 12))).astype(np.float32)
    ctau_hist = (20.0 * rng.standard_normal((B, motor.HIST_LEN, 12))).astype(np.float32)
    count = np.array([0, 24, 25, 26], np.int32)
    params = {k: np.asarray(v) for k, v in jmotor.init_motor_params(jax.random.PRNGKey(3), 12).items()}
    params = {k: (0.3 * rng.standard_normal(v.shape).astype(np.float32) if k.startswith("w") else v) for k, v in params.items()}

    jd = jax_default_dyn_params(jm, jnp.asarray(kp), jnp.asarray(kd))
    jparams = {k: (v if k == "n_layers" else jnp.asarray(v)) for k, v in params.items()}

    def jax_run(q, v, t, g, qh, ch, c):
        dyn = jd.replace(bemf_gain=g)
        st = jmotor.MotorState(qdot_hist=qh, ctau_hist=ch, count=c)
        return jmotor.pd_substeps_motor(jm, dyn, je.make_state(jm, q, v), st, jparams, t, 5, 0.001)

    jo, jst = jax.jit(jax.vmap(jax_run))(*(jnp.asarray(x) for x in (qpos, qvel, target, bemf, qdot_hist, ctau_hist, count)))
    td = dataclasses.replace(default_dyn_params(tm, kp, kd, B), bemf_gain=torch.as_tensor(bemf))
    tst = motor.MotorState(qdot_hist=torch.as_tensor(qdot_hist), ctau_hist=torch.as_tensor(ctau_hist), count=torch.as_tensor(count))
    to, tst = motor.pd_substeps_motor(tm, td, te.make_state(tm, torch.as_tensor(qpos), torch.as_tensor(qvel)), tst,
                                      convert.motor_params(params), torch.as_tensor(target), 5, 0.001)

    def rel_close(mine, theirs, name):
        theirs = np.asarray(theirs)
        err = float(np.abs(mine.numpy() - theirs).max())
        assert err <= 1e-5 * float(np.abs(theirs).max()), (name, err, float(np.abs(theirs).max()))

    for name in ("qpos", "qvel", "qacc"):
        rel_close(getattr(to, name), getattr(jo, name), name)
    rel_close(tst.qdot_hist, jst.qdot_hist, "qdot_hist")
    rel_close(tst.ctau_hist, jst.ctau_hist, "ctau_hist")
    assert tst.count.dtype == torch.int32 and tst.count.tolist() == np.asarray(jst.count).tolist() == [5, 29, 30, 31]
    assert to.contact.mask.tolist() == np.asarray(jo.contact.mask).tolist() and float(to.contact.mask.sum()) > 0


@pytest.mark.parametrize("name", ["jvrc_walk", "jvrc_step", "jvrc_walk_rough", "h1", "h1_walk", "jvrc_walk_motor"])
def test_engine_path_never_calls_the_kernel(monkeypatch, name):
    """reset and step run the engine path, never pd_substeps_kernel (which
    reset_batch and step_batch call)."""
    tenv = make_env("jvrc_walk" if name == "jvrc_walk_motor" else name,
                    path_to_json=MOTOR_JSON if name == "jvrc_walk_motor" else None, device="cpu")
    calls = []

    def refuse(*args, **kwargs):
        calls.append(kwargs)
        raise AssertionError("the engine path called pd_substeps_kernel")

    monkeypatch.setattr(th, "pd_substeps_kernel", refuse)
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = Draws(gen)
    ts = tenv.reset(2, draws)
    ts = tenv.step(ts, torch.zeros((2, tenv.action_size)), draws)
    assert calls == [] and tuple(ts.obs.shape) == (2, tenv.obs_size) and bool(torch.isfinite(ts.obs).all())
    assert (ts.motor is not None) == (name == "jvrc_walk_motor")
    with pytest.raises(AssertionError, match="pd_substeps_kernel"):
        tenv.reset_batch(2, draws)
    assert len(calls) == 1 and calls[0]["settle"]


def test_settle_env_matches_the_jax_settle(capsys):
    """The tool's settle_env (jvrc_walk, 0.2 s, B=1) against the JAX engine
    path's settle of the JAX script (reset from PRNGKey(0), then zero
    actions), every JAX draw injected: the readings it prints and returns."""
    jenv = JaxJvrcWalkEnv()
    seconds = 0.2
    steps = int(seconds / jenv.control_dt)
    keys = jax.random.PRNGKey(0)[None]
    js = jax.jit(jax.vmap(jenv.reset))(keys)
    draws = [InjectedDraws(_reset_draws("jvrc_walk", jenv, keys))]
    jstep = jax.jit(jax.vmap(jenv.step))
    for _ in range(steps):
        draws.append(InjectedDraws(_step_draws("jvrc_walk", jenv, js.key)))
        js = jstep(js, jnp.zeros((1, 12)))
    got = contact_behavior.settle_env("jvrc_walk", seconds, draws, device="cpu")
    assert steps == 8 and len(draws) == steps + 1
    l_grf, r_grf = (float(np.asarray(x)[0]) for x in jax.vmap(jenv._foot_grf)(js.physics))
    assert got["active_contacts"] == int(np.asarray(js.physics.contact.mask).sum()) > 0
    assert abs(got["root_z"] - float(np.asarray(js.physics.qpos)[0, 2])) <= 2e-3
    for mine, ref in ((got["grf_left"], l_grf), (got["grf_right"], r_grf)):
        assert abs(mine - ref) <= 0.02 * abs(ref), (mine, ref)
    assert got["done"] == bool(np.asarray(js.done)[0])
    assert abs(got["grf_left"] + got["grf_right"] - got["mg"]) < 0.1 * got["mg"]  # the feet carry the robot
    out = capsys.readouterr().out
    assert f"active contacts: {got['active_contacts']} / 8" in out and f"root z: {got['root_z']:.4f}" in out


def test_contact_behavior_command_line(capsys):
    """The tool's command line: --device cpu prints each env's readings (and
    the MuJoCo line, the JAX script's own, where mujoco imports); --device
    cuda without a card raises, as the port's CLI does."""
    contact_behavior.main(["--device", "cpu", "--seconds", "0.05", "--envs", "h1", "--mujoco"])
    out = capsys.readouterr().out
    assert "[h1] after 0.05s zero-action (cpu):" in out and "active contacts:" in out and "GRF: left" in out
    try:
        import mujoco  # noqa: F401
    except ImportError:
        assert "[mujoco] not available" in out
    else:
        from learninghumanoidwalking_tpu.models import h1 as jax_h1
        from learninghumanoidwalking_tpu.physics.mjcf import export_mjcf as jax_export_mjcf

        spec = jax_h1.h1_spec()
        model = mujoco.MjModel.from_xml_string(jax_export_mjcf(spec))
        data = mujoco.MjData(model)
        data.qpos[:] = np.concatenate([[0, 0, jax_h1.NOMINAL_HEIGHT], [1, 0, 0, 0], np.asarray(jax_h1.HALF_SITTING_POSE)])
        mujoco.mj_forward(model, data)
        for _ in range(int(0.05 / model.opt.timestep)):
            mujoco.mj_step(model, data)
        grf = 0.0
        for ci in range(data.ncon):
            f6 = np.zeros(6)
            mujoco.mj_contactForce(model, data, ci, f6)
            grf += np.linalg.norm(f6[:3])
        assert f"  [mujoco] ncon {data.ncon}  total GRF {grf:.2f} N  root z {data.qpos[2]:.4f}" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            contact_behavior.main(["--seconds", "0.05", "--envs", "h1"])


def test_env_base_pair_raises():
    """Env.reset and Env.step are abstract, as in the JAX base class."""
    with pytest.raises(NotImplementedError):
        Env().reset(1, None)
    with pytest.raises(NotImplementedError):
        Env().step(None, None, None)


def test_cartpole_reset_and_step_match_jax():
    """Cartpole's reset and step (its batch pair calls them) against
    jax.vmap of the JAX env's reset and step."""
    from learninghumanoidwalking_tpu.envs.cartpole import CartpoleEnv as JaxCartpoleEnv

    jenv, tenv = JaxCartpoleEnv(), make_env("cartpole", device="cpu")
    n = 5
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    js = jax.vmap(jenv.reset)(keys)
    ts = tenv.reset(n, InjectedDraws(cartpole_reset_draws(keys)))
    step = jax.jit(jax.vmap(jenv.step))
    actions = (np.random.default_rng(5).standard_normal((3, n, 1)) * 0.6).astype(np.float32)
    for t in range(4):
        for name in ("obs", "reward", "reward_components", "prev_action"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(ts.physics.qpos.numpy(), np.asarray(js.physics.qpos), rtol=0, atol=1e-5)
        assert ts.done.tolist() == np.asarray(js.done).tolist() and ts.steps.tolist() == np.asarray(js.steps).tolist()
        if t < 3:
            js = step(js, jnp.asarray(actions[t]))
            ts = tenv.step(ts, torch.as_tensor(actions[t]))
    batch = tenv.step_batch(tenv.reset_batch(n, InjectedDraws(cartpole_reset_draws(keys))), torch.as_tensor(actions[0]))
    first = tenv.step(tenv.reset(n, InjectedDraws(cartpole_reset_draws(keys))), torch.as_tensor(actions[0]))
    assert torch.equal(batch.physics.qpos, first.physics.qpos) and torch.equal(batch.obs, first.obs)
