"""The port's learned motor-dynamics hook (robots/motor.py) and its plain
physics path (physics/batched.py, ``motor=``) against the JAX package's,
on CPU.

The JAX motor-net weights (init_motor_params, threefry draws) are carried
to the port as numpy arrays by rl/convert.py::motor_params; histories,
states and gains are made with numpy from a seed.

Tolerances:
* one substep of the hook (motor_substep_torque_b) at counts across the
  warmup boundary and both push parities: torque 1e-6 absolute (f32
  products of the same weights, summed in another order), histories and
  counts exactly (a push copies values);
* full control steps with the motor hook at R=1 on both sides (the JAX
  batched engine runs at the R it is given; the kernel wrapper pins 1 for
  motor steps): bench.py's two-part cross-compiler gate, as
  test_torch_batched.py holds the motor-free cases, and the returned
  MotorState: histories 1e-4 relative to their largest magnitude (they
  hold velocities and torques of the two trajectories), count exactly;
* the same on terrain (K5's and K6's plain version: jvrc_step's stepping
  stones, a 16x16 heightfield with jvrc_walk_rough's compliant contacts):
  two control steps held to part 1 of the gate and the MotorState.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from learninghumanoidwalking_tpu.models import jvrc as jax_jvrc
from learninghumanoidwalking_tpu.physics import batched as jb
from learninghumanoidwalking_tpu.physics import engine as je
from learninghumanoidwalking_tpu.physics.model import default_dyn_params as jax_default_dyn_params
from learninghumanoidwalking_tpu.physics.spec import lower as jax_lower
from learninghumanoidwalking_tpu.robots import motor as jmotor
from learninghumanoidwalking_tpu_torch.models import jvrc
from learninghumanoidwalking_tpu_torch.physics import batched as tb
from learninghumanoidwalking_tpu_torch.physics import engine as te
from learninghumanoidwalking_tpu_torch.physics.model import default_dyn_params
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.rl import convert
from learninghumanoidwalking_tpu_torch.robots import motor
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

H, NU = motor.HIST_LEN, 12
KP = np.array([200, 200, 200, 250, 80, 80] * 2, np.float32)
KD = np.array([20, 20, 20, 25, 8, 8] * 2, np.float32)


@pytest.fixture(scope="module")
def params():
    jp = jmotor.init_motor_params(jax.random.PRNGKey(0), NU)
    return jp, convert.motor_params({k: np.asarray(v) for k, v in jp.items()})


def test_motor_substep_matches_jax(params):
    jp, tp = params
    counts = np.array([3, 24, 25, 26, 27, 100], np.int32)
    b = len(counts)
    rng = np.random.default_rng(3)
    qd_h = rng.standard_normal((b, H, NU)).astype(np.float32)
    ct_h = (10 * rng.standard_normal((b, H, NU))).astype(np.float32)
    qdot = rng.standard_normal((b, NU)).astype(np.float32)
    ctau = (10 * rng.standard_normal((b, NU))).astype(np.float32)

    tau_j, qh_j, ch_j, c_j = jmotor.motor_substep_torque_b(
        jp, jnp.asarray(qd_h.transpose(1, 2, 0)), jnp.asarray(ct_h.transpose(1, 2, 0)), jnp.asarray(counts),
        jnp.asarray(qdot.T), jnp.asarray(ctau.T),
    )
    tau_t, qh_t, ch_t, c_t = motor.motor_substep_torque_b(
        tp, torch.tensor(qd_h), torch.tensor(ct_h), torch.tensor(counts), torch.tensor(qdot), torch.tensor(ctau)
    )
    np.testing.assert_allclose(tau_t.numpy(), np.asarray(tau_j).T, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(qh_t.numpy(), np.asarray(qh_j).transpose(2, 0, 1))
    np.testing.assert_array_equal(ch_t.numpy(), np.asarray(ch_j).transpose(2, 0, 1))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert c_t.dtype == torch.int32
    # warm envs pass the command through; engaged envs run the net
    np.testing.assert_array_equal(tau_t[:2].numpy(), ctau[:2])
    assert float((tau_t[2:] - torch.tensor(ctau[2:])).abs().max()) > 1e-3


def test_pd_substeps_with_motor_matches_jax(params):
    """Two control steps from a state past warmup (counts 25..33, pushes on
    both parities) held to part 1 of the gate and the MotorState, then 20
    steps of PD toward the neutral pose held to part 2."""
    jp, tp = params
    b = 4
    jm, tm = jax_lower(jax_jvrc.jvrc_spec()), lower(jvrc.jvrc_spec(), device="cpu")
    rng = np.random.default_rng(5)
    pose = np.deg2rad(np.asarray(jvrc.HALF_SITTING_POSE_DEG, np.float32))
    qpos = np.tile(np.concatenate([[0, 0, jvrc.NOMINAL_HEIGHT, 1, 0, 0, 0], pose]).astype(np.float32)[None], (b, 1))
    qpos[:, :2] += 0.01 * rng.standard_normal((b, 2)).astype(np.float32)
    qvel = (0.05 * rng.standard_normal((b, 18))).astype(np.float32)
    target = (pose[None] + 0.05 * rng.standard_normal((b, NU))).astype(np.float32)
    qd_h = (0.05 * rng.standard_normal((b, H, NU))).astype(np.float32)
    ct_h = (5 * rng.standard_normal((b, H, NU))).astype(np.float32)
    counts = np.array([25, 26, 27, 33], np.int32)

    jparams = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), jax_default_dyn_params(jm, KP, KD))
    tparams = default_dyn_params(tm, KP, KD, b)
    run_j = jax.jit(lambda s, m, t: jb.pd_substeps_batched(jm, jparams, s, t, 25, 1e-3, motor=(jp, m), reuse_interval=1))

    def run_t(s, m, t):
        return tb.pd_substeps_batched(tm, tparams, s, t, 25, 1e-3, motor=(tp, m), reuse_interval=1)

    s_j = jax.vmap(lambda q, v: je.make_state(jm, q, v))(jnp.asarray(qpos), jnp.asarray(qvel))
    s_t = te.make_state(tm, torch.tensor(qpos), torch.tensor(qvel))
    m_j = jmotor.MotorState(qdot_hist=jnp.asarray(qd_h), ctau_hist=jnp.asarray(ct_h), count=jnp.asarray(counts))
    m_t = motor.MotorState(qdot_hist=torch.tensor(qd_h), ctau_hist=torch.tensor(ct_h), count=torch.tensor(counts))

    def rel_close(mine, theirs, rel):
        theirs = np.asarray(theirs)
        assert np.max(np.abs(mine.numpy() - theirs)) <= rel * np.max(np.abs(theirs))

    # part 1: two control steps
    for _ in range(2):
        (s_j, m_j), (s_t, m_t) = run_j(s_j, m_j, jnp.asarray(target)), run_t(s_t, m_t, torch.tensor(target))
        q_err = np.max(np.abs(np.asarray(s_j.qpos) - s_t.qpos.numpy()))
        grf_j = np.sum(np.linalg.norm(np.asarray(s_j.contact.force), axis=-1) * np.asarray(s_j.contact.mask), axis=1)
        grf_t = np.sum(np.linalg.norm(s_t.contact.force.numpy(), axis=-1) * s_t.contact.mask.numpy(), axis=1)
        grf_p95 = np.quantile(np.abs(grf_t - grf_j) / (np.abs(grf_j) + 50.0), 0.95)
        assert np.all(np.isfinite(s_t.qpos.numpy()))
        assert q_err < 5e-3, q_err
        assert grf_p95 < 0.04, grf_p95
        rel_close(m_t.qdot_hist, m_j.qdot_hist, 1e-4)
        rel_close(m_t.ctau_hist, m_j.ctau_hist, 1e-4)
        np.testing.assert_array_equal(m_t.count.numpy(), np.asarray(m_j.count))
    np.testing.assert_array_equal(m_t.count.numpy(), counts + 50)

    # part 2: settled statics, 20 more control steps of PD toward neutral
    neutral = np.tile(pose[None], (b, 1))
    for _ in range(20):
        s_j, m_j = run_j(s_j, m_j, jnp.asarray(neutral))
        s_t, m_t = run_t(s_t, m_t, torch.tensor(neutral))
    qj, qt = np.asarray(s_j.qpos), s_t.qpos.numpy()
    fn_j = np.sum(np.asarray(s_j.contact.force)[..., 0] * np.asarray(s_j.contact.mask), axis=1)
    fn_t = np.sum(s_t.contact.force.numpy()[..., 0] * s_t.contact.mask.numpy(), axis=1)
    weight = float(np.sum(tm.np("body_mass")) * 9.81)
    assert np.max(np.abs(qj[:, 2] - qt[:, 2])) < 2e-3
    assert np.max(np.abs(qj - qt)) < 8e-3
    assert np.max(np.abs(fn_t - fn_j) / (np.abs(fn_j) + 1.0)) < 0.02
    assert abs(np.mean(fn_t) - weight) / weight < 0.03
    np.testing.assert_array_equal(m_t.count.numpy(), np.asarray(m_j.count))


def _terrain(kind, b, rng):
    """(spec keywords, JAX Terrain, port Terrain, root lift): 20 stepping
    stones level under the feet, every third from x = 1.05 m raised 3 cm and
    all slightly yawed; or a 16x16 heightfield of U(0, 0.035) heights on
    0.25 m cells with jvrc_walk_rough's contacts (timeconst 0.04)."""
    if kind == "boxes":
        nt = 20
        pos = np.zeros((b, nt, 3), np.float32)
        pos[..., 0] = 0.3 * np.arange(nt) - 0.3
        pos[..., 2] = np.where((np.arange(nt) % 3 == 2) & (np.arange(nt) > 4), 0.03, 0.0) - 0.1
        arrays = dict(pos=pos, size=np.tile(np.array([0.15, 1.0, 0.1], np.float32), (b, nt, 1)),
                      yaw=(0.1 * rng.standard_normal((b, nt))).astype(np.float32), floor_z=np.zeros(b, np.float32))
        spec_kw, lift = dict(nterrain=nt), 0.0
    else:
        arrays = dict(pos=np.zeros((b, 0, 3), np.float32), size=np.zeros((b, 0, 3), np.float32), yaw=np.zeros((b, 0), np.float32),
                      floor_z=np.zeros(b, np.float32), hfield=rng.uniform(0.0, 0.035, (b, 16, 16)).astype(np.float32),
                      hfield_x0y0=np.tile(np.array([-1.2, -1.875], np.float32), (b, 1)), hfield_cell=np.full((b, 2), 0.25, np.float32))
        spec_kw, lift = dict(timeconst=0.04), 0.02
    return (spec_kw, je.Terrain(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            te.Terrain(**{k: torch.tensor(v) for k, v in arrays.items()}), lift)


@pytest.mark.parametrize("kind", ["boxes", "hfield"])
def test_pd_substeps_on_terrain_with_motor_matches_jax(params, kind):
    """K5's (boxes) and K6's (heightfield) plain version: two control steps
    with the motor hook on terrain from a state past warmup (counts
    25..33), against the JAX batched engine given the same terrain and the
    same nets (carried across as numpy)."""
    jp, tp = params
    b = 4
    rng = np.random.default_rng(11)
    spec_kw, jter, tter, lift = _terrain(kind, b, rng)
    jm, tm = jax_lower(jax_jvrc.jvrc_spec(**spec_kw)), lower(jvrc.jvrc_spec(**spec_kw), device="cpu")
    pose = np.deg2rad(np.asarray(jvrc.HALF_SITTING_POSE_DEG, np.float32))
    qpos = np.tile(np.concatenate([[0, 0, jvrc.NOMINAL_HEIGHT + lift, 1, 0, 0, 0], pose]).astype(np.float32)[None], (b, 1))
    qpos[:, :2] += 0.01 * rng.standard_normal((b, 2)).astype(np.float32)
    qvel = (0.05 * rng.standard_normal((b, 18))).astype(np.float32)
    target = (pose[None] + 0.05 * rng.standard_normal((b, NU))).astype(np.float32)
    qd_h = (0.05 * rng.standard_normal((b, H, NU))).astype(np.float32)
    ct_h = (5 * rng.standard_normal((b, H, NU))).astype(np.float32)
    counts = np.array([25, 26, 27, 33], np.int32)
    jparams = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), jax_default_dyn_params(jm, KP, KD))
    tparams = default_dyn_params(tm, KP, KD, b)
    run_j = jax.jit(lambda s, m: jb.pd_substeps_batched(jm, jparams, s, jnp.asarray(target), 25, 1e-3, jter, motor=(jp, m),
                                                        reuse_interval=1))
    s_j = jax.vmap(lambda q, v: je.make_state(jm, q, v))(jnp.asarray(qpos), jnp.asarray(qvel))
    s_t = te.make_state(tm, torch.tensor(qpos), torch.tensor(qvel))
    m_j = jmotor.MotorState(qdot_hist=jnp.asarray(qd_h), ctau_hist=jnp.asarray(ct_h), count=jnp.asarray(counts))
    m_t = motor.MotorState(qdot_hist=torch.tensor(qd_h), ctau_hist=torch.tensor(ct_h), count=torch.tensor(counts))
    for _ in range(2):
        s_j, m_j = run_j(s_j, m_j)
        s_t, m_t = tb.pd_substeps_batched(tm, tparams, s_t, torch.tensor(target), 25, 1e-3, tter, motor=(tp, m_t), reuse_interval=1)
        grf_j = np.sum(np.linalg.norm(np.asarray(s_j.contact.force), axis=-1) * np.asarray(s_j.contact.mask), axis=1)
        grf_t = np.sum(np.linalg.norm(s_t.contact.force.numpy(), axis=-1) * s_t.contact.mask.numpy(), axis=1)
        assert np.all(np.isfinite(s_t.qpos.numpy()))
        assert np.max(np.abs(np.asarray(s_j.qpos) - s_t.qpos.numpy())) < 5e-3
        assert np.quantile(np.abs(grf_t - grf_j) / (np.abs(grf_j) + 50.0), 0.95) < 0.04
        for mine, theirs in ((m_t.qdot_hist, m_j.qdot_hist), (m_t.ctau_hist, m_j.ctau_hist)):
            assert np.max(np.abs(mine.numpy() - np.asarray(theirs))) <= 1e-4 * np.max(np.abs(np.asarray(theirs)))
        np.testing.assert_array_equal(m_t.count.numpy(), np.asarray(m_j.count))
    np.testing.assert_array_equal(m_t.count.numpy(), counts + 50)
    assert float(s_t.contact.mask.sum()) > 0  # the feet stand on the terrain


def test_load_motor_params_round_trips_npz(tmp_path, params):
    jp, tp = params
    path = tmp_path / "motor.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in jp.items()})
    loaded = motor.load_motor_params(str(path), NU)
    assert loaded["n_layers"] == tp["n_layers"] == 3
    assert set(loaded) == set(tp)
    for k in tp:
        if k != "n_layers":
            assert loaded[k].dtype == torch.float32
            np.testing.assert_array_equal(loaded[k].numpy(), tp[k].numpy())
    with pytest.raises(ValueError, match="joints"):
        motor.load_motor_params(str(path), NU + 1)
