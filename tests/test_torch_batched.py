"""The port's plain K1 (physics/batched.py) against the JAX batched engine on CPU.

Same jvrc model, same noisy states, gains and targets (made with numpy from
a seed) go through both packages' ``pd_substeps_batched``.

Tolerances:
* smooth quantities (FK, motion subspace, body velocities, spatial
  inertias, generalized smooth forces, mass-matrix Cholesky): 1e-5 absolute
  on O(1) quantities, 1e-5 relative on the force and matrix scales — f32
  rounding of two implementations of the same formulas;
* full control steps with contact: bench.py's two-part cross-compiler gate
  (bench.py:117-196), used as it stands. Part 1, one control step from a
  noisy state: qpos max-abs < 5e-3 and total-GRF relative error p95 < 4%
  (+50 N floor). Part 2, 20 more steps of PD toward the neutral pose: root
  dz < 2e-3, qpos max-abs < 8e-3, normal force < 2% relative (+1 N floor),
  mean normal force within 3% of the weight. Contacts on a friction-cone
  boundary flip between compilers, so max-abs on qvel and GRF is no gate.
  The zero-torque settle launch is held to part 1 only: part 2 measures PD
  statics, and settle substeps apply no torque.
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
from learninghumanoidwalking_tpu_torch.models import jvrc
from learninghumanoidwalking_tpu_torch.physics import batched as tb
from learninghumanoidwalking_tpu_torch.physics import engine as te
from learninghumanoidwalking_tpu_torch.physics.model import default_dyn_params
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.utils import maths
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

B = 4
KP = np.array([200, 200, 200, 250, 80, 80] * 2, np.float32)
KD = np.array([20, 20, 20, 25, 8, 8] * 2, np.float32)


@pytest.fixture(scope="module")
def models():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return jax_lower(jax_jvrc.jvrc_spec()), lower(jvrc.jvrc_spec(), device="cpu")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pose = np.deg2rad(np.asarray(jvrc.HALF_SITTING_POSE_DEG, np.float32))
    nominal = np.concatenate([[0, 0, jvrc.NOMINAL_HEIGHT, 1, 0, 0, 0], pose]).astype(np.float32)
    qpos = np.tile(nominal[None], (B, 1))
    qpos[:, :2] += 0.01 * rng.standard_normal((B, 2)).astype(np.float32)
    qvel = (0.05 * rng.standard_normal((B, 18))).astype(np.float32)
    target = (pose[None] + 0.05 * rng.standard_normal((B, 12))).astype(np.float32)
    return qpos, qvel, target, pose


def _jax_params(jm):
    p1 = jax_default_dyn_params(jm, KP, KD)
    return jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), p1)


def test_smooth_quantities_match_jax(models):
    jm, tm = models
    qpos, qvel, target, _ = _inputs(1)
    # randomized masses / CoMs / wrenches so the DynParams paths are exercised
    rng = np.random.default_rng(2)
    jp = _jax_params(jm)
    mass = np.asarray(jp.body_mass) * rng.uniform(0.95, 1.05, (B, tm.nbody)).astype(np.float32)
    ipos = np.asarray(jp.body_ipos) + rng.uniform(-0.01, 0.01, (B, tm.nbody, 3)).astype(np.float32)
    xfrc = rng.uniform(-5, 5, (B, tm.nbody, 6)).astype(np.float32)
    damp = rng.uniform(0.02, 2.0, (B, tm.nv)).astype(np.float32)
    fric = rng.uniform(0.0, 2.0, (B, tm.nv)).astype(np.float32)
    jp = jp.replace(body_mass=jnp.asarray(mass), body_ipos=jnp.asarray(ipos), xfrc=jnp.asarray(xfrc),
                    dof_damping=jnp.asarray(damp), dof_frictionloss=jnp.asarray(fric))
    tp = default_dyn_params(tm, KP, KD, B)
    tp.body_mass, tp.body_ipos, tp.xfrc = torch.tensor(mass), torch.tensor(ipos), torch.tensor(xfrc)
    tp.dof_damping, tp.dof_frictionloss = torch.tensor(damp), torch.tensor(fric)
    ctrl = (target - qpos[:, 7:]) * KP[None]

    # JAX side, trailing batch
    jpt = jb._params_to_trailing(jp)
    q_t, v_t = jnp.asarray(qpos.T), jnp.asarray(qvel.T)
    xpos_j, xquat_j = jb.fk_b(jm, q_t)
    rm_j = jb._quat_to_mat(xquat_j.transpose(1, 0, 2)).transpose(2, 0, 1, 3)
    jac_j, s_j, cvel_j, iner_j, qfrc_j, act_j = jb.smooth_forces_b(jm, jpt, q_t, v_t, xpos_j, xquat_j, rm_j, jnp.asarray(ctrl.T))
    chol_j = jb.factorize_b(jm, jpt, jac_j, iner_j, 1e-3)

    # port, leading batch
    q, v = torch.tensor(qpos), torch.tensor(qvel)
    xpos, xquat = tb.fk_b(tm, q)
    rm = maths.quat_to_mat(xquat)
    jac, s, cvel, iner, qfrc, act = tb.smooth_forces_b(tm, tp, q, v, xpos, xquat, rm, torch.tensor(ctrl))
    chol = tb.factorize_b(tm, tp, jac, iner, 1e-3)

    def close(mine, theirs, rel=False):
        mine = mine.numpy()
        scale = max(1.0, float(np.abs(theirs).max())) if rel else 1.0
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-5 * scale)

    close(xpos, np.transpose(np.asarray(xpos_j), (2, 0, 1)))
    close(xquat, np.transpose(np.asarray(xquat_j), (2, 0, 1)))
    close(s, np.transpose(np.asarray(s_j), (2, 0, 1)))
    close(cvel, np.transpose(np.asarray(cvel_j), (2, 0, 1)))
    close(iner, np.transpose(np.asarray(iner_j), (3, 0, 1, 2)), rel=True)
    close(qfrc, np.asarray(qfrc_j).T, rel=True)
    close(act, np.asarray(act_j).T, rel=True)
    close(chol, np.transpose(np.asarray(chol_j), (2, 0, 1)), rel=True)


def _total_grf(force, mask):
    return np.sum(np.linalg.norm(force, axis=-1) * mask, axis=1)


def _terrain_case(kind, rng):
    """(JAX model, port model, JAX Terrain, port Terrain, root lift) for a
    terrain kind: flat floor; 20 stepping-stone boxes (level under the feet,
    every third raised 3 cm from x = 1.05 m on, yawed, every other env with
    its floor 2 m down); a 16x16 heightfield of
    U(0, 0.035) heights, 0.25 m cells, with the compliant contacts of
    jvrc_walk_rough (timeconst 0.04)."""
    spec_kw, lift, arrays = {}, 0.0, None
    if kind == "boxes":
        nt = 20
        pos = np.zeros((B, nt, 3), np.float32)
        pos[..., 0] = 0.3 * np.arange(nt) - 0.3
        pos[..., 1] = 0.05 * rng.standard_normal((B, 1))
        pos[..., 2] = np.where((np.arange(nt) % 3 == 2) & (np.arange(nt) > 4), 0.03, 0.0) - 0.1
        arrays = dict(
            pos=pos, size=np.tile(np.array([0.15, 1.0, 0.1], np.float32), (B, nt, 1)),
            yaw=(0.1 * rng.standard_normal((B, nt))).astype(np.float32),
            floor_z=np.where(np.arange(B) % 2 == 0, 0.0, -2.0).astype(np.float32),
        )
        spec_kw = dict(nterrain=nt)
    elif kind == "hfield":
        arrays = dict(
            pos=np.zeros((B, 0, 3), np.float32), size=np.zeros((B, 0, 3), np.float32), yaw=np.zeros((B, 0), np.float32),
            floor_z=np.zeros(B, np.float32), hfield=rng.uniform(0.0, 0.035, (B, 16, 16)).astype(np.float32),
            hfield_x0y0=np.tile(np.array([-1.2, -1.875], np.float32), (B, 1)),
            hfield_cell=np.full((B, 2), 0.25, np.float32),
        )
        spec_kw, lift = dict(timeconst=0.04), 0.02
    jm, tm = jax_lower(jax_jvrc.jvrc_spec(**spec_kw)), lower(jvrc.jvrc_spec(**spec_kw), device="cpu")
    if arrays is None:
        return jm, tm, None, None, lift
    jt = je.Terrain(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tt = te.Terrain(**{k: torch.tensor(v) for k, v in arrays.items()})
    return jm, tm, jt, tt, lift


# (terrain, R, settle); the flat cases keep their ids. Terrain models run at
# R=1, as the reference pins them.
CASES = [
    pytest.param("flat", 1, False, id="step-1"),
    pytest.param("flat", 5, False, id="step-5"),
    pytest.param("flat", 1, True, id="settle-1"),
    pytest.param("flat", 5, True, id="settle-5"),
    pytest.param("boxes", 1, False, id="boxes-step-1"),
    pytest.param("boxes", 1, True, id="boxes-settle-1"),
    pytest.param("hfield", 1, False, id="hfield-step-1"),
    pytest.param("hfield", 1, True, id="hfield-settle-1"),
]


@pytest.mark.parametrize("terrain_kind, reuse, settle", CASES)
def test_pd_substeps_matches_jax(terrain_kind, reuse, settle):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jm, tm, jter, tter, lift = _terrain_case(terrain_kind, np.random.default_rng(7))
    qpos, qvel, target, pose = _inputs(0)
    qpos[:, 2] += lift
    # settle runs 3 substeps; R=5 does not divide 3, so both sides fall back to R=1
    frame_skip = 3 if settle else 25
    jp = _jax_params(jm)
    tp = default_dyn_params(tm, KP, KD, B)

    run_j = jax.jit(lambda s, t: jb.pd_substeps_batched(jm, jp, s, t, frame_skip, 1e-3, jter, settle=settle, reuse_interval=reuse))

    def run_t(s, t):
        return tb.pd_substeps_batched(tm, tp, s, t, frame_skip, 1e-3, tter, settle=settle, reuse_interval=reuse)

    s_j = jax.vmap(lambda q, v: je.make_state(jm, q, v))(jnp.asarray(qpos), jnp.asarray(qvel))
    s_t = te.make_state(tm, torch.tensor(qpos), torch.tensor(qvel))

    # part 1: one control step from a noisy state
    o_j, o_t = run_j(s_j, jnp.asarray(target)), run_t(s_t, torch.tensor(target))
    q_err = np.max(np.abs(np.asarray(o_j.qpos) - o_t.qpos.numpy()))
    grf_j = _total_grf(np.asarray(o_j.contact.force), np.asarray(o_j.contact.mask))
    grf_t = _total_grf(o_t.contact.force.numpy(), o_t.contact.mask.numpy())
    grf_p95 = np.quantile(np.abs(grf_t - grf_j) / (np.abs(grf_j) + 50.0), 0.95)
    assert np.all(np.isfinite(o_t.qpos.numpy()))
    assert q_err < 5e-3, q_err
    assert grf_p95 < 0.04, grf_p95
    if settle:
        return

    # part 2: settled statics, 20 more control steps of PD toward neutral
    neutral = np.tile(pose[None], (B, 1))
    for _ in range(20):
        o_j = run_j(o_j, jnp.asarray(neutral))
        o_t = run_t(o_t, torch.tensor(neutral))
    qj, qt = np.asarray(o_j.qpos), o_t.qpos.numpy()
    dz = np.max(np.abs(qj[:, 2] - qt[:, 2]))
    sq_err = np.max(np.abs(qj - qt))
    fn_j = np.sum(np.asarray(o_j.contact.force)[..., 0] * np.asarray(o_j.contact.mask), axis=1)
    fn_t = np.sum(o_t.contact.force.numpy()[..., 0] * o_t.contact.mask.numpy(), axis=1)
    fn_rel = np.max(np.abs(fn_t - fn_j) / (np.abs(fn_j) + 1.0))
    weight = float(np.sum(tm.np("body_mass")) * 9.81)
    vs_weight = abs(np.mean(fn_t) - weight) / weight
    assert dz < 2e-3, dz
    assert sq_err < 8e-3, sq_err
    assert fn_rel < 0.02, fn_rel
    assert vs_weight < 0.03, vs_weight


def test_side_face_contact_matches_jax():
    """Feet flying forward into a riser (the scenario of the JAX package's
    tests/test_kernel.py side-face test): the port's plain version against
    the JAX batched engine over 14 control steps of 5 substeps. The riser's
    face pushes the toe back (a horizontal -x contact normal), which must
    engage at some step. Tolerances as the JAX test's: qpos 5e-4, contact
    frames 1e-4 (the contact turns on and off within the run, so rounding
    differences of the two engines grow over it)."""
    b, nt = 8, 2
    jm, tm = jax_lower(jax_jvrc.jvrc_spec(nterrain=nt)), lower(jvrc.jvrc_spec(nterrain=nt), device="cpu")
    pose = np.deg2rad(np.asarray(jvrc.HALF_SITTING_POSE_DEG, np.float32))
    qpos = np.tile(np.concatenate([[0, 0, jvrc.NOMINAL_HEIGHT, 1, 0, 0, 0], pose]).astype(np.float32)[None], (b, 1))
    qvel = np.zeros((b, 18), np.float32)
    qvel[:, 0] = 1.0
    # a tall step ahead: riser face at x = 0.20, top at z = 0.6
    arrays = dict(
        pos=np.tile(np.array([[0.40, 0.0, 0.3], [9.0, 9.0, -0.07]], np.float32)[None], (b, 1, 1)),
        size=np.tile(np.array([[0.2, 1.0, 0.3], [0.5, 0.5, 0.1]], np.float32)[None], (b, 1, 1)),
        yaw=np.zeros((b, nt), np.float32),
        floor_z=np.zeros(b, np.float32),
    )
    jter = je.Terrain(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tter = te.Terrain(**{k: torch.tensor(v) for k, v in arrays.items()})
    target = np.tile(pose[None], (b, 1))
    jp = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), jax_default_dyn_params(jm, KP, KD))
    tp = default_dyn_params(tm, KP, KD, b)
    run_j = jax.jit(lambda s: jb.pd_substeps_batched(jm, jp, s, jnp.asarray(target), 5, 1e-3, jter))
    s_j = jax.vmap(lambda q, v: je.make_state(jm, q, v))(jnp.asarray(qpos), jnp.asarray(qvel))
    s_t = te.make_state(tm, torch.tensor(qpos), torch.tensor(qvel))
    engaged = False
    for _ in range(14):
        s_j = run_j(s_j)
        s_t = tb.pd_substeps_batched(tm, tp, s_t, torch.tensor(target), 5, 1e-3, tter)
        normals = s_t.contact.frame[:, :, 0].numpy()
        active = s_t.contact.mask.numpy() > 0
        engaged |= bool(active.any() and (normals[active][:, 0] < -0.9).any())
    np.testing.assert_allclose(s_t.qpos.numpy(), np.asarray(s_j.qpos), rtol=0, atol=5e-4)
    np.testing.assert_allclose(s_t.contact.frame.numpy(), np.asarray(s_j.contact.frame), rtol=0, atol=1e-4)
    assert engaged, "no side-face contact engaged"
