"""The port's physics against the MuJoCo binary, by the method and gates of
tests/test_mujoco_golden.py.

The port's own export_mjcf (physics/mjcf.py) writes the RobotSpec that the
port lowers; MuJoCo runs the same PD-held dynamics from the same state, and
trajectories and ground reaction forces are compared:

* the PD-held trajectory through robots/pd.py::pd_substeps (the engine step,
  one env), JVRC-1 and Unitree H1: 500 substeps of 1 ms, mean |dz| < 5 mm,
  settled total GRF within 5%, total mass to 1e-4;
* the batched engine (physics/batched.py, the kernels' plain version) at
  R=5, JVRC-1: the same gates at the 5-substep cadence;
* stepping-stone statics on two raised, yawed boxes: mean |dz| < 5 mm,
  settled GRF within 5%;
* a foot flying into a riser's side face: mean |dx| < 3 cm, final dx < 6 cm,
  mean |dz| < 2 cm;
* self collision: engine.self_collision fires within 60 ms of MuJoCo's first
  proxy contact on a leg-crossing trajectory, and not before.

Skipped where mujoco is not installed. Each case runs the port's engine
eagerly on the CPU, one env, at roughly 40 ms a substep; the cases over
~15 s are marked slow, as every case of the JAX file is (measured alone on
the development machine: stepping stones 34 s, R=5 21 s, JVRC-1 20 s,
riser 19 s, H1 18 s; self collision 9 s stays in the default run).
"""

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from learninghumanoidwalking_tpu_torch.models import h1, jvrc  # noqa: E402
from learninghumanoidwalking_tpu_torch.physics import batched, engine  # noqa: E402
from learninghumanoidwalking_tpu_torch.physics.mjcf import export_mjcf  # noqa: E402
from learninghumanoidwalking_tpu_torch.physics.model import default_dyn_params  # noqa: E402
from learninghumanoidwalking_tpu_torch.physics.spec import lower  # noqa: E402
from learninghumanoidwalking_tpu_torch.robots.pd import pd_substeps  # noqa: E402

JVRC_KP = np.array([200, 200, 200, 250, 80, 80] * 2, dtype=np.float64)
JVRC_KD = np.array([20, 20, 20, 25, 8, 8] * 2, dtype=np.float64)


def _run_mujoco(xml, qpos0, pose, kp, kd, steps, qvel0=None):
    mj_model = mujoco.MjModel.from_xml_string(xml)
    mj_data = mujoco.MjData(mj_model)
    act_qpos = [mj_model.jnt_qposadr[mj_model.actuator_trnid[i, 0]] for i in range(mj_model.nu)]
    act_dof = [mj_model.jnt_dofadr[mj_model.actuator_trnid[i, 0]] for i in range(mj_model.nu)]
    mj_data.qpos[:] = qpos0
    mj_data.qvel[:] = 0 if qvel0 is None else qvel0
    mujoco.mj_forward(mj_model, mj_data)
    zs, grf, xs = [], [], []
    for _ in range(steps):
        mj_data.ctrl[:] = kp * (pose - mj_data.qpos[act_qpos]) - kd * mj_data.qvel[act_dof]
        mujoco.mj_step(mj_model, mj_data)
        zs.append(mj_data.qpos[2])
        xs.append(mj_data.qpos[0])
        f_tot = 0.0
        for ci in range(mj_data.ncon):
            f6 = np.zeros(6)
            mujoco.mj_contactForce(mj_model, mj_data, ci, f6)
            f_tot += np.linalg.norm(f6[:3])
        grf.append(f_tot)
    return np.array(zs), np.array(grf), mj_model.body_mass.sum(), np.array(xs)


def _start(spec, qpos0, kp, kd, qvel0=None):
    model = lower(spec, device="cpu")
    params = default_dyn_params(model, np.asarray(kp, np.float32), np.asarray(kd, np.float32), 1)
    qvel = torch.zeros((1, model.nv)) if qvel0 is None else torch.tensor(np.asarray(qvel0, np.float32))[None]
    state = engine.make_state(model, torch.tensor(np.asarray(qpos0, np.float32))[None], qvel)
    return model, params, state


def _grf(state):
    return float(torch.sum(torch.linalg.vector_norm(state.contact.force, dim=-1) * state.contact.mask))


@torch.no_grad()
def _run_port(spec, qpos0, pose, kp, kd, steps, qvel0=None, terrain=None):
    model, params, state = _start(spec, qpos0, kp, kd, qvel0)
    target = torch.tensor(np.asarray(pose, np.float32))[None]
    zs, grf, xs = [], [], []
    for _ in range(steps):
        state = pd_substeps(model, params, state, target, 1, 0.001, terrain=terrain)
        zs.append(float(state.qpos[0, 2]))
        xs.append(float(state.qpos[0, 0]))
        grf.append(_grf(state))
    return np.array(zs), np.array(grf), float(np.sum(model.np("body_mass"))), np.array(xs)


def _terrain(boxes, nterrain, floor_z=0.0):
    """One env's terrain: ``boxes`` (pos, size, yaw) first, the rest far away."""
    pos = np.full((nterrain, 3), [50.0, 50.0, -0.07], np.float32)
    size = np.tile(np.array([0.5, 0.5, 0.1], np.float32), (nterrain, 1))
    yaw = np.zeros(nterrain, np.float32)
    for i, (p, s, y) in enumerate(boxes):
        pos[i], size[i], yaw[i] = p, s, y
    return engine.Terrain(pos=torch.tensor(pos)[None], size=torch.tensor(size)[None], yaw=torch.tensor(yaw)[None],
                          floor_z=torch.tensor([floor_z], dtype=torch.float32))


def _jvrc_qpos0(lift=0.0):
    pose = np.deg2rad(jvrc.HALF_SITTING_POSE_DEG)
    return np.concatenate([[0, 0, jvrc.NOMINAL_HEIGHT + lift], [1, 0, 0, 0], pose]), pose


@pytest.mark.slow
@pytest.mark.parametrize("robot", ["jvrc", "h1"])
def test_pd_held_trajectory_matches_mujoco(robot):
    if robot == "jvrc":
        spec, kp, kd = jvrc.jvrc_spec(), JVRC_KP, JVRC_KD
        qpos0, pose = _jvrc_qpos0()
    else:
        spec = h1.h1_spec()
        pose = np.asarray(h1.HALF_SITTING_POSE)
        kp = np.array([100, 100, 100, 100, 20] * 2, dtype=np.float64)
        kd = np.array([10, 10, 10, 10, 4] * 2, dtype=np.float64)
        qpos0 = np.concatenate([[0, 0, h1.NOMINAL_HEIGHT], [1, 0, 0, 0], pose])
    steps = 500  # 0.5 s: before falling trajectories part chaotically
    zs_mj, grf_mj, mass_mj, _ = _run_mujoco(export_mjcf(spec), qpos0, pose, kp, kd, steps)
    zs_p, grf_p, mass_p, _ = _run_port(spec, qpos0, pose, kp, kd, steps)
    np.testing.assert_allclose(mass_p, mass_mj, rtol=1e-4)
    assert np.abs(zs_mj - zs_p).mean() < 0.005, f"mean |dz| {np.abs(zs_mj - zs_p).mean():.4f}"
    assert abs(grf_mj[300:].mean() - grf_p[300:].mean()) / grf_mj[300:].mean() < 0.05


@pytest.mark.slow
@torch.no_grad()
def test_pd_held_trajectory_reuse5_matches_mujoco():
    """The batched engine with the factorization reused over 5 substeps
    (the kernels' plain version at K1's R) inside the same gates."""
    spec = jvrc.jvrc_spec()
    qpos0, pose = _jvrc_qpos0()
    steps = 500
    zs_mj, grf_mj, _, _ = _run_mujoco(export_mjcf(spec), qpos0, pose, JVRC_KP, JVRC_KD, steps)
    model, params, state = _start(spec, qpos0, JVRC_KP, JVRC_KD)
    target = torch.tensor(np.asarray(pose, np.float32))[None]
    zs_p, grf_p = [], []
    for _ in range(steps // 5):
        state = batched.pd_substeps_batched(model, params, state, target, 5, 0.001, reuse_interval=5)
        zs_p.append(float(state.qpos[0, 2]))
        grf_p.append(_grf(state))
    zs_p, grf_p = np.array(zs_p), np.array(grf_p)
    zs_mj5, grf_mj5 = zs_mj[4::5], grf_mj[4::5]
    assert np.abs(zs_mj5 - zs_p).mean() < 0.005, f"mean |dz| {np.abs(zs_mj5 - zs_p).mean():.4f}"
    assert abs(grf_mj5[60:].mean() - grf_p[60:].mean()) / grf_mj5[60:].mean() < 0.05


@pytest.mark.slow
def test_stepping_stone_statics_match_mujoco():
    """Settled statics on two raised, yawed stones under the feet (MuJoCo
    boxes; the stones cover all four corners of each sole)."""
    spec = jvrc.jvrc_spec(nterrain=4)
    boxes = [((0.114, 0.12, 0.03), (0.2, 0.12, 0.05), 0.05), ((0.114, -0.12, 0.03), (0.2, 0.12, 0.05), -0.05)]
    qpos0, pose = _jvrc_qpos0(0.08)
    steps = 500
    zs_mj, grf_mj, _, _ = _run_mujoco(export_mjcf(spec, terrain_boxes=boxes), qpos0, pose, JVRC_KP, JVRC_KD, steps)
    zs_p, grf_p, _, _ = _run_port(spec, qpos0, pose, JVRC_KP, JVRC_KD, steps, terrain=_terrain(boxes, 4))
    assert np.abs(zs_mj - zs_p).mean() < 0.005, f"mean |dz| {np.abs(zs_mj - zs_p).mean():.4f}"
    assert abs(grf_mj[300:].mean() - grf_p[300:].mean()) / grf_mj[300:].mean() < 0.05


@pytest.mark.slow
def test_riser_side_face_matches_mujoco():
    """A foot driven into a stair riser (a box's side face) is stopped as
    MuJoCo stops it: the robot pitches forward over the step in both."""
    spec = jvrc.jvrc_spec(nterrain=2)
    boxes = [((0.44, 0.0, 0.3), (0.2, 1.0, 0.3), 0.0)]
    qpos0, pose = _jvrc_qpos0()
    qvel0 = np.zeros(18)
    qvel0[0] = 1.0  # flying forward at 1 m/s
    steps = 300
    zs_mj, _, _, xs_mj = _run_mujoco(export_mjcf(spec, terrain_boxes=boxes), qpos0, pose, JVRC_KP, JVRC_KD, steps, qvel0=qvel0)
    zs_p, _, _, xs_p = _run_port(spec, qpos0, pose, JVRC_KP, JVRC_KD, steps, qvel0=qvel0, terrain=_terrain(boxes, 2))
    assert np.abs(xs_mj - xs_p).mean() < 0.03, f"mean |dx| {np.abs(xs_mj - xs_p).mean():.4f}"
    assert abs(xs_mj[-1] - xs_p[-1]) < 0.06, f"final dx {abs(xs_mj[-1] - xs_p[-1]):.4f}"
    assert np.abs(zs_mj - zs_p).mean() < 0.02, f"mean |dz| {np.abs(zs_mj - zs_p).mean():.4f}"


@torch.no_grad()
def test_self_collision_fires_with_mujoco():
    """The right leg adducted hard across the left: the port's
    engine.self_collision fires within 60 substeps of MuJoCo's first contact
    between the foot proxies (exported in their own collision class), and
    not before."""
    spec = jvrc.jvrc_spec()
    qpos0, pose = _jvrc_qpos0()
    target = pose.copy()
    target[jvrc.LEG_JOINTS.index("R_HIP_R")] += 0.9
    steps = 800

    mj_model = mujoco.MjModel.from_xml_string(export_mjcf(spec, self_proxy_collisions=True))
    prox = [g for g in range(mj_model.ngeom) if "prox" in (mujoco.mj_id2name(mj_model, mujoco.mjtObj.mjOBJ_GEOM, g) or "")]
    assert prox, "proxy spheres missing from the exported MJCF"
    mj_data = mujoco.MjData(mj_model)
    act_qpos = [mj_model.jnt_qposadr[mj_model.actuator_trnid[i, 0]] for i in range(mj_model.nu)]
    act_dof = [mj_model.jnt_dofadr[mj_model.actuator_trnid[i, 0]] for i in range(mj_model.nu)]
    mj_data.qpos[:] = qpos0
    mujoco.mj_forward(mj_model, mj_data)
    t_mj = None
    for t in range(steps):
        mj_data.ctrl[:] = JVRC_KP * (target - mj_data.qpos[act_qpos]) - JVRC_KD * mj_data.qvel[act_dof]
        mujoco.mj_step(mj_model, mj_data)
        if any(mj_data.contact.geom1[ci] in prox and mj_data.contact.geom2[ci] in prox for ci in range(mj_data.ncon)):
            t_mj = t
            break
    assert t_mj is not None, "MuJoCo never reported a proxy self-contact"

    model, params, state = _start(spec, qpos0, JVRC_KP, JVRC_KD)
    tgt = torch.tensor(np.asarray(target, np.float32))[None]
    flags = []
    for _ in range(min(steps, t_mj + 61)):
        state = pd_substeps(model, params, state, tgt, 1, 0.001)
        flags.append(bool(engine.self_collision(model, state.xpos, state.xquat)[0]))
    flags = np.array(flags)
    assert flags.any(), "engine.self_collision never fired on the crossing trajectory"
    t_port = int(np.argmax(flags))
    assert abs(t_port - t_mj) <= 60, f"port {t_port} vs mujoco {t_mj}"
    assert not flags[: max(t_mj - 60, 0)].any()
