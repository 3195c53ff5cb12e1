"""MJCF export and import (physics/mjcf.py, physics/mjcf_import.py), the
``mjcf:`` walking env (envs/mjcf_env.py) and its command line, against the
JAX package on the CPU.

Tolerances:
* export_mjcf: the same XML text, character for character (both format
  the same float64 spec values with the same rules);
* import_mjcf: the same RobotSpec field for field (both parse the same
  text with the same arithmetic), and the same lowered model: every table
  as float64 within 1e-12 (both lower in float64 and store float32);
* MjcfWalkEnv: reset_batch and step_batch at B=1 and B=4 against the JAX
  env's reset_batch and step_batch, with the JAX task draws injected:
  observations, rewards and weighted reward components 1e-3 absolute,
  done flags exactly (as tests/test_torch_env.py holds jvrc_walk). The
  JAX package's own test calls its single-env reset and step, which run
  its single-env engine step, another contact solve than its batched
  engine (their reset observations differ by up to 3.6e-3 in joint
  velocities on this robot); the port has only the batch API, so B=1 of
  the batch API is the like-for-like case.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import yaml

from learninghumanoidwalking_tpu.envs.mjcf_env import MjcfWalkEnv as JaxMjcfWalkEnv
from learninghumanoidwalking_tpu.models import cartpole as jax_cartpole
from learninghumanoidwalking_tpu.models import h1 as jax_h1
from learninghumanoidwalking_tpu.models import jvrc as jax_jvrc
from learninghumanoidwalking_tpu.physics.mjcf import export_mjcf as jax_export_mjcf
from learninghumanoidwalking_tpu.physics.mjcf_import import import_mjcf as jax_import_mjcf
from learninghumanoidwalking_tpu.physics.spec import lower as jax_lower
from learninghumanoidwalking_tpu_torch import run_experiment as cli
from learninghumanoidwalking_tpu_torch.envs.mjcf_env import MjcfWalkEnv
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.models import cartpole, h1, jvrc
from learninghumanoidwalking_tpu_torch.ops import substep_kernel as sk
from learninghumanoidwalking_tpu_torch.physics.mjcf import export_mjcf
from learninghumanoidwalking_tpu_torch.physics.mjcf_import import import_mjcf
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.rl.checkpoint import Checkpointer
from learninghumanoidwalking_tpu_torch.utils.config import Configuration
from learninghumanoidwalking_tpu_torch.utils.seeding import InjectedDraws
from test_torch_env import reset_draws, step_draws
from test_torch_ops import FLAT

# 20 stepping stones as (pos, size, yaw), a heightfield (nrow, ncol, rx, ry, zmax, cx, cy)
_rng = np.random.default_rng(4)
BOXES = [((0.3 * i - 0.3, float(0.05 * _rng.standard_normal()), -0.1), (0.15, 1.0, 0.1), float(0.1 * _rng.standard_normal()))
         for i in range(20)]
HFIELD = (16, 16, 1.875, 1.875, 0.035, 0.675, 0.0)

EXPORTS = {
    "jvrc": (lambda m: m.jvrc_spec(), {}),
    "h1": (lambda m: m.h1_spec(), {}),
    "cartpole": (lambda m: m.cartpole_spec(), dict(with_floor=False)),
    "jvrc_step": (lambda m: m.jvrc_spec(nterrain=20), dict(terrain_boxes=BOXES, floor_z=-0.5)),
    "jvrc_hfield": (lambda m: m.jvrc_spec(timeconst=0.04), dict(hfield=HFIELD)),
    "h1_self_proxies_visual": (lambda m: m.h1_spec(), dict(self_proxy_collisions=True, visual=True, timestep=0.002)),
}
MODULES = {"jvrc": (jax_jvrc, jvrc), "h1": (jax_h1, h1), "cartpole": (jax_cartpole, cartpole)}
FEET = {"jvrc": (["L_foot"], ["R_foot"]), "h1": (["left_foot"], ["right_foot"]), "cartpole": ([], [])}


def _specs(case):
    make, kw = EXPORTS[case]
    robot = case.split("_")[0]
    jax_mod, mod = MODULES[robot]
    return make(jax_mod), make(mod), kw, robot


@pytest.mark.parametrize("case", list(EXPORTS))
def test_export_mjcf_writes_the_jax_text(case):
    jax_spec, spec, kw, _ = _specs(case)
    text = export_mjcf(spec, **kw)
    assert text == jax_export_mjcf(jax_spec, **kw)
    assert text.startswith(f"<mujoco model='{spec.name}'>")


# inline MJCF of the importer's subset: <default> classes, euler in degrees,
# fullinertia, slide joints, sphere/capsule geoms, a skipped mesh, position
# actuators, ctrlrange under autolimits
INLINE = {
    "defaults_euler": """
    <mujoco model='t'>
      <compiler angle='degree'/>
      <option gravity='0 0 -9.7'/>
      <default>
        <joint damping='0.5' armature='0.02'/>
        <default class='foot'>
          <geom friction='0.9 0.005 0.0001' type='box'/>
        </default>
      </default>
      <worldbody>
        <body name='base' pos='0 0 1'>
          <freejoint/>
          <inertial pos='0 0 0' mass='2.0' diaginertia='0.1 0.1 0.1'/>
          <body name='link' pos='0 0 -0.2' euler='0 90 0'>
            <joint name='j1' type='hinge' axis='0 1 0'/>
            <inertial pos='0 0 -0.1' mass='1.0' diaginertia='0.01 0.01 0.01'/>
            <geom name='foot_box' class='foot' size='0.1 0.05 0.02'/>
          </body>
        </body>
      </worldbody>
      <actuator><motor joint='j1' gear='5'/></actuator>
    </mujoco>""",
    "fullinertia_slide_radians": """
    <mujoco model='f'>
      <compiler angle='radian'/>
      <worldbody>
        <body name='cart' pos='0 0 0.5' euler='0.1 0.2 0.3'>
          <joint name='s' type='slide' axis='1 0 0' frictionloss='0.3'/>
          <inertial pos='0.01 0 0' mass='3' fullinertia='0.3 0.2 0.1 0.01 0.02 0.03'/>
          <geom type='mesh' mesh='m'/>
          <geom name='ball' type='sphere' size='0.05' density='500'/>
          <body name='arm' pos='0 0 0.1'>
            <joint name='h' axis='0 1 0'/>
            <geom name='rod' type='capsule' size='0.02 0.3' pos='0 0 0.3'/>
          </body>
        </body>
      </worldbody>
      <actuator>
        <position joint='s' gear='10' ctrlrange='-2 2'/>
        <motor joint='h' ctrllimited='false' ctrlrange='-1 1'/>
      </actuator>
    </mujoco>""",
}
AUTOLIMITS = """
    <mujoco model='a'>
      <compiler angle='degree'{auto}/>
      <worldbody>
        <body name='b' pos='0 0 1'>
          <joint name='j' type='hinge' axis='0 0 1'/>
          <inertial pos='0 0 0' mass='1' diaginertia='0.1 0.1 0.1'/>
          <geom type='box' size='0.1 0.1 0.1'/>
        </body>
      </worldbody>
      <actuator><motor joint='j' gear='2'{lim} ctrlrange='-1 1'/></actuator>
    </mujoco>"""
for _auto in ("", " autolimits='false'"):
    for _lim in ("", " ctrllimited='false'", " ctrllimited='true'"):
        INLINE[f"autolimits{_auto != ''}_{_lim.strip() or 'none'}"] = AUTOLIMITS.format(auto=_auto, lim=_lim)


def _lowered_tables_equal(spec, jax_spec):
    """The port's and the JAX package's lowering of the two specs: every
    field of the Model equal (tables as float64 within 1e-12)."""
    a, b = lower(spec, device="cpu"), jax_lower(jax_spec)
    compared = 0
    for f in dataclasses.fields(a):
        mine, theirs = getattr(a, f.name), getattr(b, f.name, None)
        if torch.is_tensor(mine):
            np.testing.assert_allclose(mine.numpy().astype(np.float64), np.asarray(theirs, np.float64), rtol=0, atol=1e-12,
                                       err_msg=f.name)
            compared += 1
        elif isinstance(mine, (int, tuple, str)) and theirs is not None:
            assert tuple(mine) == tuple(theirs) if isinstance(mine, tuple) else mine == theirs, f.name
    assert compared >= 10


@pytest.mark.parametrize("case", ["jvrc", "h1", "cartpole", "jvrc_step"] + list(INLINE))
def test_import_mjcf_gives_the_jax_spec_and_tables(case):
    if case in INLINE:
        text, feet, pairs = INLINE[case], ((["foot_box"], []) if case == "defaults_euler" else ([], [])), ()
    else:
        jax_spec, spec, kw, robot = _specs(case)
        text, feet, pairs = jax_export_mjcf(jax_spec, **kw), FEET[robot], spec.self_collision_pairs
    kw_imp = dict(left_foot_geoms=feet[0], right_foot_geoms=feet[1], self_collision_pairs=pairs)
    if case == "jvrc_step":
        kw_imp["nterrain"] = 20
    spec = import_mjcf(text, **kw_imp)
    jax_spec = jax_import_mjcf(text, **kw_imp)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jax_spec)
    _lowered_tables_equal(spec, jax_spec)
    if case in EXPORTS:  # the round trip: the imported model runs the native one's kernel tables
        _, native, _, _ = _specs(case)
        assert [b.name for b in spec.bodies] == [b.name for b in native.bodies]


def test_import_reads_a_file_and_the_kernel_caps_bound_it(tmp_path):
    """A path ending in .xml is read from disk; a model past K1's caps
    (16 bodies) raises check_model's message rather than run."""
    path = tmp_path / "jvrc.xml"
    path.write_text(export_mjcf(jvrc.jvrc_spec()))
    spec = import_mjcf(str(path), left_foot_geoms=["L_foot"], right_foot_geoms=["R_foot"])
    sk.check_model(lower(spec, device="cpu"), FLAT)
    chain = "".join(f"<body name='b{i}' pos='0 0 -0.1'><joint name='j{i}' axis='0 1 0'/>"
                    f"<inertial pos='0 0 0' mass='1' diaginertia='0.1 0.1 0.1'/>" for i in range(16)) + "</body>" * 16
    big = import_mjcf(f"<mujoco><worldbody><body name='base' pos='0 0 2'><freejoint/>"
                      f"<inertial pos='0 0 0' mass='1' diaginertia='0.1 0.1 0.1'/>{chain}</body></worldbody></mujoco>")
    with pytest.raises(ValueError, match="exceed caps"):
        sk.check_model(lower(big, device="cpu"), FLAT)


def test_configuration_merged_is_deep():
    base = Configuration({"a": 1, "robot": {"x": 1, "y": {"z": 2, "w": 3}}, "l": [1, 2]})
    out = base.merged(Configuration({"robot": {"y": {"z": 5}}, "l": [3], "b": None}))
    assert out.to_dict() == {"a": 1, "robot": {"x": 1, "y": {"z": 5, "w": 3}}, "l": [3], "b": None}
    assert base.robot.y.z == 2  # the merge copies


ROBOT = dict(
    kp=[200, 200, 200, 250, 80, 80, 200, 200, 200, 250, 80, 80],
    kd=[20, 20, 20, 25, 8, 8, 20, 20, 20, 25, 8, 8],
    half_sitting_pose=[-30, 0, 0, 50, 0, -24, -30, 0, 0, 50, 0, -24],
    robot=dict(left_foot_geoms=["L_foot"], right_foot_geoms=["R_foot"], root_body="PELVIS_S", head_body="NECK_P_S",
               lfoot_body="L_ANKLE_P_S", rfoot_body="R_ANKLE_P_S", nominal_height=0.81),
)


def _robot_files(tmp_path, **extra):
    """JVRC-1 as an MJCF file, and its robot file as JSON (the port) and as
    YAML (the JAX package), with the same values."""
    xml = tmp_path / "robot.xml"
    xml.write_text(export_mjcf(jvrc.jvrc_spec()))
    cfg = {**ROBOT, **extra}
    (tmp_path / "robot.json").write_text(json.dumps(cfg))
    (tmp_path / "robot.yaml").write_text(yaml.safe_dump(cfg))
    return str(xml), str(tmp_path / "robot.json"), str(tmp_path / "robot.yaml")


def test_mjcf_env_without_robot_roles_raises(tmp_path):
    xml, _, _ = _robot_files(tmp_path)
    with pytest.raises(ValueError, match="robot"):
        MjcfWalkEnv(xml, None, device="cpu")


@pytest.mark.parametrize("batch", [1, 4])
def test_mjcf_env_matches_jax(tmp_path, batch):
    """make_env("mjcf:<xml>") against the JAX MjcfWalkEnv: reset and two
    steps with the JAX draws injected, both at the R the environment asks
    for."""
    extra = {}
    if batch == 4:  # the mirror lists enable the mirror loss
        extra["robot"] = dict(ROBOT["robot"], mirrored_obs=[-0.1, 1, -2, 3, -4] + list(range(5, 29)), mirrored_acts=list(range(12)))
    xml, robot_json, robot_yaml = _robot_files(tmp_path, **extra)
    jenv = JaxMjcfWalkEnv(xml, robot_yaml)
    tenv = make_env(f"mjcf:{xml}", robot_json, device="cpu")
    assert isinstance(tenv, MjcfWalkEnv)
    assert tenv.obs_mean is None and tenv.obs_size == jenv.obs_size == 37 and tenv.action_size == 12
    assert tenv.physics_reuse == jenv.physics_reuse
    assert tenv.mirrored_obs == jenv.mirrored_obs and tenv.mirrored_acts == jenv.mirrored_acts
    keys = jax.random.split(jax.random.PRNGKey(batch), batch)
    step = jax.jit(jenv.step_batch)
    js = jax.jit(jenv.reset_batch)(keys)
    ts = tenv.reset_batch(batch, InjectedDraws(reset_draws(keys, jenv.period)))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
    rng = np.random.default_rng(batch)
    for _ in range(2):
        actions = (0.2 * rng.standard_normal((batch, 12))).astype(np.float32)
        draws = InjectedDraws(step_draws(js.key))
        js = step(js, jnp.asarray(actions))
        ts = tenv.step_batch(ts, torch.tensor(actions), draws)
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
        np.testing.assert_allclose(ts.reward_components.numpy(), np.asarray(js.reward_components), rtol=0, atol=1e-3)
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))


def test_mjcf_env_through_the_command_line(tmp_path):
    """train --env mjcf:<xml> --json <robot.json> on the CPU: the running
    norm's warmup, then one iteration; experiment.json keeps both paths
    absolute, so eval --path rebuilds the env. (The robot file's control
    step of 5 ms, 5 substeps, keeps the CPU run short.)"""
    xml, robot_json, _ = _robot_files(tmp_path, control_dt=0.005)
    common = ["--device", "cpu", "--num-envs", "4", "--rollout-len", "2", "--minibatch-size", "8", "--max-traj-len", "2"]
    out = cli.train(["--env", f"mjcf:{xml}", "--json", robot_json, "--logdir", str(tmp_path / "logs"), "--n-itr", "1", *common])
    assert out["run_dir"].name.startswith("mjcf-robot-")
    meta = Checkpointer.load_experiment(out["run_dir"])
    assert meta["env"] == f"mjcf:{xml}" and meta["json"] == robot_json
    assert float(out["ts"].norm.count) == pytest.approx(1e-4 + 5 * 2 * 4)
    assert all(np.isfinite(m["actor_loss"]) for m in out["history"])
    ev = cli.evaluate(["--path", str(out["run_dir"]), "--episodes", "1", "--max-steps", "2", "--device", "cpu"])
    assert ev["steps"] == 2 and np.isfinite(ev["rewards"]).all()
