"""Engine tables, contact constants, state construction and self-collision
(the part of learninghumanoidwalking_tpu/physics/engine.py that the
jvrc_walk path needs).

The readable single-env engine of the JAX package (``engine.step``) is not
ported yet; the batch path lives in physics/batched.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.physics.model import FREE, HINGE, SLIDE, Contact, Model, PhysicsState
from learninghumanoidwalking_tpu_torch.utils import maths

# Contacts activate when signed distance < margin (MuJoCo default margin 0).
CONTACT_MARGIN = 0.0

# The 4 bottom-face corners of each foot box (engine.py:41-67 of the JAX
# package): a static corner set, 4 contact slots per foot geom.
_BOTTOM_CORNERS = np.array(
    [[sx, sy, -1.0] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)],
    dtype=np.float32,
)
# static contact frame rows (normal, t1, t2) = (z, x, y) for the flat floor
_Z_FRAME = np.eye(3, dtype=np.float32)[[2, 0, 1]]


@lru_cache(maxsize=32)
def _static_tables(
    nbody: int,
    nv: int,
    body_parent: tuple,
    jnt_type: tuple,
    body_dof_adr: tuple,
    body_dof_num: tuple,
    body_qpos_adr: tuple,
):
    """Ancestor masks and stacked per-dof index arrays (numpy constants)."""
    anc = np.zeros((nbody, nv), dtype=np.float32)
    for i in range(1, nbody):
        anc[i] = anc[body_parent[i]]
        adr, num = body_dof_adr[i], body_dof_num[i]
        if num > 0:
            anc[i, adr : adr + num] = 1.0

    j_dof, j_body, j_is_hinge, j_qpos = [], [], [], []
    free_body = -1
    for i in range(1, nbody):
        jt = jnt_type[i]
        if jt == FREE:
            free_body = i
        elif jt in (HINGE, SLIDE):
            j_dof.append(body_dof_adr[i])
            j_body.append(i)
            j_is_hinge.append(1.0 if jt == HINGE else 0.0)
            j_qpos.append(body_qpos_adr[i])
    return dict(
        anc=anc,
        j_dof=np.asarray(j_dof, dtype=np.int64),
        j_body=np.asarray(j_body, dtype=np.int64),
        j_is_hinge=np.asarray(j_is_hinge, dtype=np.float32),
        j_qpos=np.asarray(j_qpos, dtype=np.int64),
        free_body=free_body,
    )


def _tables(model: Model) -> dict:
    return _static_tables(
        model.nbody,
        model.nv,
        model.body_parent,
        model.jnt_type,
        tuple(model.body_dof_adr),
        tuple(model.body_dof_num),
        tuple(model.body_qpos_adr),
    )


def slots_per_geom(model: Model) -> int:
    """Contact slots per foot geom: 4 bottom corners vs the floor (terrain
    models, not ported yet, add 4 corner-vs-box slots)."""
    return 4 if model.nterrain == 0 else 8


def slot_geoms(model: Model) -> np.ndarray:
    """(nc,) foot-geom index of every contact slot."""
    return np.repeat(np.asarray(model.foot_geoms, dtype=np.int64), slots_per_geom(model))


def geom_world_pose(model: Model, xpos: torch.Tensor, xquat: torch.Tensor, gi: int):
    """(B, 3) position and (B, 4) orientation of geom ``gi``."""
    bi = model.geom_body[gi]
    pos = xpos[:, bi] + maths.quat_rotate(xquat[:, bi], model.geom_pos[gi])
    quat = maths.quat_mul(xquat[:, bi], model.geom_quat[gi])
    return pos, quat


def make_state(model: Model, qpos: torch.Tensor, qvel: torch.Tensor) -> PhysicsState:
    """Fresh batch-leading PhysicsState (B envs) with caches filled via FK."""
    # batched.py imports this module for its tables, so import it here
    from learninghumanoidwalking_tpu_torch.physics.batched import body_velocities_b, fk_b, motion_subspace_b

    qpos = qpos.to(torch.float32)
    qvel = qvel.to(torch.float32)
    batch = qpos.shape[0]
    dev = qpos.device
    xpos, xquat = fk_b(model, qpos)
    rmats = maths.quat_to_mat(xquat)
    cvel = body_velocities_b(model, motion_subspace_b(model, xpos, rmats), qvel)
    ncon = model.ncon
    contact = Contact(
        pos=torch.zeros((batch, ncon, 3), device=dev),
        frame=torch.as_tensor(_Z_FRAME, device=dev).expand(batch, ncon, 3, 3).clone(),
        dist=torch.full((batch, ncon), 1e3, device=dev),
        geom=torch.zeros((batch, ncon), dtype=torch.int32, device=dev),
        force=torch.zeros((batch, ncon, 3), device=dev),
        mask=torch.zeros((batch, ncon), device=dev),
    )
    return PhysicsState(
        qpos=qpos,
        qvel=qvel,
        qacc=torch.zeros((batch, model.nv), device=dev),
        act_torque=torch.zeros((batch, model.nu), device=dev),
        xpos=xpos,
        xquat=xquat,
        cvel=cvel,
        contact=contact,
        time=torch.zeros((batch,), device=dev),
    )


def self_collision(model: Model, xpos: torch.Tensor, xquat: torch.Tensor) -> torch.Tensor:
    """(B,) bool: any declared sphere-proxy pair overlapping (termination only)."""
    if not model.self_pairs:
        return torch.zeros(xpos.shape[0], dtype=torch.bool, device=xpos.device)
    size = model.np("geom_size")
    flags = []
    for g1, g2 in model.self_pairs:
        p1, _ = geom_world_pose(model, xpos, xquat, g1)
        p2, _ = geom_world_pose(model, xpos, xquat, g2)
        r1r2 = float(size[g1, 0] + size[g2, 0])
        flags.append(torch.sum(torch.square(p1 - p2), dim=-1) < r1r2 * r1r2)
    return torch.any(torch.stack(flags, dim=-1), dim=-1)
