"""State accessors over (Model, PhysicsState), batch-leading (counterpart
of learninghumanoidwalking_tpu/physics/interface.py, the reference's
RobotInterface read-outs): CoM, momenta, body velocities, actuated joint
state, name lookups, foot contacts and ground reaction forces.

A state function returns (B, ...) where the JAX function returns (...) for
one env; a model function returns what the JAX one does (tuples of indices
and names, tensors of the model's tables). Plain tensor functions: they
read the state that the control-step kernels write.
"""

from __future__ import annotations

import torch

from learninghumanoidwalking_tpu_torch.physics import engine
from learninghumanoidwalking_tpu_torch.physics.model import DynParams, Model, PhysicsState
from learninghumanoidwalking_tpu_torch.utils import maths


def body_coms(model: Model, state: PhysicsState) -> torch.Tensor:
    """(B, nbody, 3) world CoM of each body."""
    rmats = maths.quat_to_mat(state.xquat)
    return state.xpos + torch.einsum("nbij,bj->nbi", rmats, model.body_ipos)


def robot_com(model: Model, state: PhysicsState) -> torch.Tensor:
    """(B, 3) whole-robot CoM."""
    mass = model.body_mass
    return torch.sum(mass[:, None] * body_coms(model, state), dim=1) / torch.sum(mass)


def _com_velocities(model: Model, state: PhysicsState, coms: torch.Tensor) -> torch.Tensor:
    w, v0 = state.cvel[..., :3], state.cvel[..., 3:]
    return v0 + maths.cross(w, coms)


def body_linear_momentum(model: Model, state: PhysicsState) -> torch.Tensor:
    """(B, 3) total linear momentum."""
    v_com = _com_velocities(model, state, body_coms(model, state))
    return torch.sum(model.body_mass[:, None] * v_com, dim=1)


def body_angular_momentum(model: Model, state: PhysicsState) -> torch.Tensor:
    """(B, 3) angular momentum about the robot CoM."""
    coms = body_coms(model, state)
    com = robot_com(model, state)
    rot = maths.quat_to_mat(state.xquat) @ maths.quat_to_mat(model.body_iquat)
    i_world = torch.einsum("nbij,bj,nbkj->nbik", rot, model.body_inertia, rot)
    w = state.cvel[..., :3]
    spin = torch.einsum("nbij,nbj->nbi", i_world, w)
    orbital = maths.cross(coms - com[:, None, :], model.body_mass[:, None] * _com_velocities(model, state, coms))
    return torch.sum(spin + orbital, dim=1)


def body_velocity(model: Model, state: PhysicsState, body: int, local: bool = False):
    """((B, 3) linear, (B, 3) angular) velocity of a body frame origin,
    world frame or, with ``local``, the body's."""
    w = state.cvel[:, body, :3]
    v = state.cvel[:, body, 3:] + maths.cross(w, state.xpos[:, body])
    if local:
        q = state.xquat[:, body]
        v, w = maths.quat_rotate_inv(q, v), maths.quat_rotate_inv(q, w)
    return v, w


def act_joint_positions(model: Model, state: PhysicsState) -> torch.Tensor:
    return state.qpos[:, list(model.actuator_qpos)]


def act_joint_velocities(model: Model, state: PhysicsState) -> torch.Tensor:
    return state.qvel[:, list(model.actuator_dof)]


def act_joint_torques(model: Model, state: PhysicsState) -> torch.Tensor:
    """(B, nu) joint-level actuator torques (gear x ctrl)."""
    return state.act_torque


def total_mass(model: Model) -> float:
    return float(model.np("body_mass").sum())


# name and address lookups: static metadata, plain Python values


def jnt_id_by_name(model: Model, name: str) -> int:
    """Body index owning the named joint."""
    return model.joint_names.index(name)


def jnt_qposadr_by_name(model: Model, name: str) -> int:
    return model.body_qpos_adr[model.joint_names.index(name)]


def jnt_qveladr_by_name(model: Model, name: str) -> int:
    return model.body_dof_adr[model.joint_names.index(name)]


def motor_names(model: Model) -> tuple:
    return model.actuator_names


def actuated_joint_inds(model: Model) -> tuple:
    """Body indices of the actuated joints."""
    return model.actuator_body


def actuated_joint_names(model: Model) -> tuple:
    return tuple(model.joint_names[b] for b in model.actuator_body)


def motor_qposadr(model: Model) -> tuple:
    return model.actuator_qpos


def gear_ratios(model: Model) -> torch.Tensor:
    return model.actuator_gear


def act_joint_ranges(model: Model) -> torch.Tensor:
    """(nu, 2) actuated-joint limits: the ctrlrange-derived bounds, as in
    the JAX package (the engine enforces no joint limit)."""
    return model.actuator_ctrlrange


def actuator_ctrl_range(model: Model) -> torch.Tensor:
    return model.actuator_ctrlrange


# raw state


def qpos(state: PhysicsState) -> torch.Tensor:
    return state.qpos


def qvel(state: PhysicsState) -> torch.Tensor:
    return state.qvel


def qacc(state: PhysicsState) -> torch.Tensor:
    return state.qacc


def cvel(state: PhysicsState) -> torch.Tensor:
    return state.cvel


def root_body_pos(model: Model, state: PhysicsState, root: int = 1) -> torch.Tensor:
    return state.xpos[:, root]


def root_body_vel(model: Model, state: PhysicsState, root: int = 1):
    return body_velocity(model, state, root)


def object_xpos_by_name(model: Model, state: PhysicsState, name: str) -> torch.Tensor:
    return state.xpos[:, model.body_names.index(name)]


def object_xquat_by_name(model: Model, state: PhysicsState, name: str) -> torch.Tensor:
    return state.xquat[:, model.body_names.index(name)]


def object_affine_by_name(model: Model, state: PhysicsState, name: str) -> torch.Tensor:
    """(B, 4, 4) homogeneous transform of the named body."""
    bi = model.body_names.index(name)
    out = torch.zeros(state.xpos.shape[:1] + (4, 4), dtype=state.xpos.dtype, device=state.xpos.device)
    out[:, :3, :3] = maths.quat_to_mat(state.xquat[:, bi])
    out[:, :3, 3] = state.xpos[:, bi]
    out[:, 3, 3] = 1.0
    return out


def body_ext_force(model: Model, params: DynParams, body: int) -> torch.Tensor:
    """(B, 6) applied world wrench on a body (DynParams.xfrc)."""
    return params.xfrc[:, body]


# contacts and ground reaction forces


def foot_slot_mask(model: Model, geoms) -> torch.Tensor:
    """(nc,) 1.0 on the contact slots of the given foot geoms."""
    sel = [1.0 if g in geoms else 0.0 for g in engine.slot_geoms(model)]
    return torch.as_tensor(sel, dtype=torch.float32, device=model.device)


def contact_point_z(state: PhysicsState) -> torch.Tensor:
    """(B,) lowest active contact z, 0 when airborne."""
    mask = state.contact.mask > 0
    z = torch.where(mask, state.contact.pos[..., 2], torch.full_like(state.contact.pos[..., 2], 1e3))
    return torch.where(torch.any(mask, dim=-1), torch.min(z, dim=-1).values, torch.zeros_like(z[:, 0]))


def body_floor_contacts(model: Model, state: PhysicsState, geoms) -> torch.Tensor:
    """(B, nc) active-contact mask restricted to the given foot geoms."""
    return state.contact.mask * foot_slot_mask(model, set(geoms))


def rfoot_floor_contacts(model: Model, state: PhysicsState) -> torch.Tensor:
    return body_floor_contacts(model, state, model.right_foot_geoms)


def lfoot_floor_contacts(model: Model, state: PhysicsState) -> torch.Tensor:
    return body_floor_contacts(model, state, model.left_foot_geoms)


def _force_magnitudes(state: PhysicsState) -> torch.Tensor:
    return torch.linalg.vector_norm(state.contact.force, dim=-1) * state.contact.mask


def body_contact_force(model: Model, state: PhysicsState, geoms) -> torch.Tensor:
    """(B,) summed |contact force| over the given geoms' active slots."""
    return torch.sum(_force_magnitudes(state) * foot_slot_mask(model, set(geoms)), dim=-1)


def rfoot_grf(model: Model, state: PhysicsState) -> torch.Tensor:
    return body_contact_force(model, state, model.right_foot_geoms)


def lfoot_grf(model: Model, state: PhysicsState) -> torch.Tensor:
    return body_contact_force(model, state, model.left_foot_geoms)


def check_rfoot_floor_collision(model: Model, state: PhysicsState) -> torch.Tensor:
    return torch.any(rfoot_floor_contacts(model, state) > 0, dim=-1)


def check_lfoot_floor_collision(model: Model, state: PhysicsState) -> torch.Tensor:
    return torch.any(lfoot_floor_contacts(model, state) > 0, dim=-1)


def check_bad_collisions(model: Model, state: PhysicsState) -> torch.Tensor:
    """(B,) bool: a non-foot body touching. Only feet carry contact slots,
    so this is the self-collision proxy the tasks terminate on, as in the
    JAX package."""
    return engine.self_collision(model, state.xpos, state.xquat)


def _foot_body(model: Model, geoms) -> int:
    return model.geom_body[geoms[0]]


def rfoot_body_pos(model: Model, state: PhysicsState) -> torch.Tensor:
    return state.xpos[:, _foot_body(model, model.right_foot_geoms)]


def lfoot_body_pos(model: Model, state: PhysicsState) -> torch.Tensor:
    return state.xpos[:, _foot_body(model, model.left_foot_geoms)]


def rfoot_body_vel(model: Model, state: PhysicsState):
    return body_velocity(model, state, _foot_body(model, model.right_foot_geoms))


def lfoot_body_vel(model: Model, state: PhysicsState):
    return body_velocity(model, state, _foot_body(model, model.left_foot_geoms))


def interaction_force(model: Model, state: PhysicsState) -> torch.Tensor:
    """(B,) total |contact force| across all active slots."""
    return torch.sum(_force_magnitudes(state), dim=-1)
