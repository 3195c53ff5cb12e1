"""The port's terrain queries and terrain contact detection against the JAX
engine, on CPU.

Inputs come from numpy with a fixed seed. The port's queries take a batch of
envs with K points each; the JAX engine's take one env and one point and are
vmapped here.

Tolerances: 1e-6 absolute on heights, distances, normals and frames (O(1)
values; the two implementations run the same float32 formulas, so they
differ by a few roundings at most); contact masks exactly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from learninghumanoidwalking_tpu.models import jvrc as jax_jvrc
from learninghumanoidwalking_tpu.physics import batched as jb
from learninghumanoidwalking_tpu.physics import engine as je
from learninghumanoidwalking_tpu.physics.spec import lower as jax_lower
from learninghumanoidwalking_tpu_torch.models import jvrc
from learninghumanoidwalking_tpu_torch.physics import batched as tb
from learninghumanoidwalking_tpu_torch.physics import engine as te
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.utils import maths
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

TOL = 1e-6
HF_X0Y0 = (-1.2, -1.875)


def _terrains(pos, size, yaw, floor_z, hfield=None, x0y0=None, cell=None):
    """The same terrain for both packages: (JAX Terrain, port Terrain)."""
    arrays = dict(pos=pos, size=size, yaw=yaw, floor_z=floor_z, hfield=hfield, hfield_x0y0=x0y0, hfield_cell=cell)
    jt = je.Terrain(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    tt = te.Terrain(**{k: None if v is None else torch.tensor(v) for k, v in arrays.items()})
    return jt, tt


def _per_point(fn, jt, points):
    """JAX single-env, single-point query over (B, K, ...) points."""
    return jax.vmap(lambda t, ps: jax.vmap(lambda p: fn(t, p))(ps))(jt, jnp.asarray(points))


def test_point_queries_match_jax():
    rng = np.random.default_rng(0)
    b, k = 4, 12
    # boxes: 0 a tall riser resting on the floor, 1 a floating box, 2 a thin
    # floating box centred on x = 0.9 (the lx = 0 case), 3-4 random
    pos = np.array([[0.4, 0.0, 0.3], [-0.5, 0.5, 0.4], [0.9, -0.6, 0.5], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    size = np.array([[0.2, 1.0, 0.3], [0.3, 0.3, 0.1], [0.05, 1.0, 1.0], [0.2, 0.2, 0.1], [0.2, 0.2, 0.1]], np.float32)
    pos = np.tile(pos[None], (b, 1, 1))
    size = np.tile(size[None], (b, 1, 1))
    pos[:, 3:, :2] = rng.uniform(-1.0, 1.0, (b, 2, 2))
    yaw = np.zeros((b, 5), np.float32)
    yaw[:, 3:] = rng.uniform(-1.0, 1.0, (b, 2))
    floor_z = np.zeros(b, np.float32)
    hfield = rng.uniform(0.0, 0.035, (b, 16, 16)).astype(np.float32)
    x0y0 = np.tile(np.array(HF_X0Y0, np.float32), (b, 1))
    x0y0[0] = 0.0  # env 0: node (15, 15) at exactly (3.75, 3.75)
    cell = np.full((b, 2), 0.25, np.float32)

    pts = rng.uniform(-1.0, 1.0, (b, k, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-0.05, 0.7, (b, k))
    pts[0, 0] = [3.75, 1.0, 0.02]  # on the grid edge: u = W - 1 exactly
    pts[1, 0] = [9.0, -9.0, 0.01]  # beyond the grid: clipped to the corner node
    pts[:, 1] = [0.22, 0.1, 0.3]  # inside the riser near its -x side face
    pts[:, 2] = [-0.5, 0.5, 0.31]  # inside the floating box near its bottom face
    pts[:, 3] = [0.9, -0.6, 0.5]  # the thin box's centre: lx = 0, normal along x
    pts[:, 4] = [0.5, 0.0, 0.58]  # inside the riser near its top

    jt, tt = _terrains(pos, size, yaw, floor_z, hfield, x0y0, cell)
    tp = torch.tensor(pts)

    h_j, n_j = _per_point(lambda t, p: je.hfield_query(t, p[:2]), jt, pts)
    h_t, n_t = te.hfield_query(tt, tp[..., :2])
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=0, atol=TOL)

    s_j = _per_point(lambda t, p: je.support_height(t, p[:2]), jt, pts)
    np.testing.assert_allclose(te.support_height(tt, tp[..., :2]).numpy(), np.asarray(s_j), rtol=0, atol=TOL)

    d_j, nn_j = _per_point(je.terrain_contact, jt, pts)
    d_t, nn_t = te.terrain_contact(tt, tp)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(nn_t.numpy(), np.asarray(nn_j), rtol=0, atol=TOL)
    fr_j = jax.vmap(jax.vmap(je.frame_from_normal))(nn_j)
    np.testing.assert_allclose(te.frame_from_normal(nn_t).numpy(), np.asarray(fr_j), rtol=0, atol=TOL)

    # the special cases are what they claim to be
    n = nn_t.numpy()
    assert np.allclose(n[:, 1], [-1.0, 0.0, 0.0]), n[:, 1]  # riser side face
    assert np.allclose(n[:, 2], [0.0, 0.0, -1.0]), n[:, 2]  # floating box: bottom face
    assert np.all(n[:, 3] == 0.0), n[:, 3]  # sign(0) = 0: no normal
    assert np.allclose(n[:, 4], [0.0, 0.0, 1.0]), n[:, 4]  # resting column: top face
    assert np.all(d_t.numpy()[:, 1:5] < 0)


def _stepping_boxes(b, rng):
    """20 stepping-stone boxes per env under and ahead of the feet, half-size
    (0.15, 1, 0.1), tops at z in {0, 0.03}, yawed a little; every other env
    has its floor 2 m down (FORWARD mode)."""
    nt = 20
    pos = np.zeros((b, nt, 3), np.float32)
    pos[..., 0] = 0.3 * np.arange(nt) - 0.3
    pos[..., 1] = 0.05 * rng.standard_normal((b, 1))
    pos[..., 2] = np.where(np.arange(nt) % 3 == 2, 0.03, 0.0) - 0.1
    size = np.tile(np.array([0.15, 1.0, 0.1], np.float32), (b, nt, 1))
    yaw = (0.1 * rng.standard_normal((b, nt))).astype(np.float32)
    floor_z = np.where(np.arange(b) % 2 == 0, 0.0, -2.0).astype(np.float32)
    return pos, size, yaw, floor_z


def _hfield(b, rng):
    return (
        rng.uniform(0.0, 0.035, (b, 16, 16)).astype(np.float32),
        np.tile(np.array(HF_X0Y0, np.float32), (b, 1)),
        np.full((b, 2), 0.25, np.float32),
    )


def _feet_states(b, rng, lift):
    """Nominal JVRC poses with the feet at z ~ lift, shifted over the boxes
    and turned, so corners land on tops and near riser faces."""
    pose = np.deg2rad(np.asarray(jvrc.HALF_SITTING_POSE_DEG, np.float32))
    qpos = np.tile(np.concatenate([[0, 0, jvrc.NOMINAL_HEIGHT, 1, 0, 0, 0], pose]).astype(np.float32)[None], (b, 1))
    qpos[:, 0] = rng.uniform(-0.1, 0.1, b)
    qpos[:, 2] += lift + rng.uniform(-0.01, 0.01, b)
    yaw = rng.uniform(-0.3, 0.3, b)
    qpos[:, 3], qpos[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    qpos[:, 7:] += 0.05 * rng.standard_normal((b, 12)).astype(np.float32)
    return qpos


@pytest.mark.parametrize("kind", ["boxes", "hfield"])
def test_detect_contacts_matches_jax(kind):
    rng = np.random.default_rng(1)
    b = 8
    if kind == "boxes":
        jm, tm = jax_lower(jax_jvrc.jvrc_spec(nterrain=20)), lower(jvrc.jvrc_spec(nterrain=20), device="cpu")
        jt, tt = _terrains(*_stepping_boxes(b, rng))
        qpos = _feet_states(b, rng, lift=0.0)
    else:
        jm, tm = jax_lower(jax_jvrc.jvrc_spec()), lower(jvrc.jvrc_spec(), device="cpu")
        empty = (np.zeros((b, 0, 3), np.float32), np.zeros((b, 0, 3), np.float32), np.zeros((b, 0), np.float32))
        jt, tt = _terrains(*empty, np.zeros(b, np.float32), *_hfield(b, rng))
        qpos = _feet_states(b, rng, lift=0.015)

    q_t = jnp.asarray(qpos.T)
    xpos_j, xquat_j = jb.fk_b(jm, q_t)
    rm_j = jb._quat_to_mat(xquat_j.transpose(1, 0, 2)).transpose(2, 0, 1, 3)
    cpos_j, dist_j, mask_j, frame_j = jb.detect_contacts_b(jm, xpos_j, xquat_j, rm_j, jb._terrain_to_trailing(jt))

    xpos, xquat = tb.fk_b(tm, torch.tensor(qpos))
    cpos, dist, mask, frame = tb.detect_contacts_b(tm, xpos, xquat, maths.quat_to_mat(xquat), tt)

    np.testing.assert_allclose(cpos.numpy(), np.transpose(np.asarray(cpos_j), (2, 0, 1)), rtol=0, atol=TOL)
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j).T, rtol=0, atol=TOL)
    np.testing.assert_allclose(frame.numpy(), np.transpose(np.asarray(frame_j), (3, 0, 1, 2)), rtol=0, atol=TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j).T)
    # non-vacuous: terrain slots in contact, and (heightfield) with tilted normals
    if kind == "boxes":
        box_slot = np.array([(s // 4) % 2 == 1 for s in range(tm.ncon)])
        assert mask.numpy()[:, box_slot].sum() > 0
    else:
        active = mask.numpy() > 0
        assert active.sum() > 0 and (1.0 - frame.numpy()[..., 0, 2])[active].max() > 1e-3
