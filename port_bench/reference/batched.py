"""Frozen copy of learninghumanoidwalking_tpu_torch/physics/batched.py at commit 9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f
(imports made relative), part of the benchmark's plain reference: it does
not follow later changes of the program. The original docstring follows.

Batched rigid-body engine: the plain PyTorch version of kernels K1-K4
(counterpart of learninghumanoidwalking_tpu/physics/batched.py): flat
floor, terrain boxes, heightfield, and the learned motor hook.

The JAX module keeps the batch as the TRAILING axis for the TPU's lane
layout; here the batch LEADS, which is the natural PyTorch layout, and every
``vmap``/``scan`` of the JAX version is a written-out batch axis or a
Python loop. The math, including the factorization-reuse cache contract of
``step_b``, follows the JAX version line for line.

Layouts: qpos (B, nq), qvel (B, nv), xpos (B, nb, 3), xquat (B, nb, 4),
rmats (B, nb, 3, 3), S (B, nv, 6), cvel (B, nb, 6), inertias
(B, nb, 6, 6), jac (B, nb, 6, nv), M / chol (B, nv, nv), contacts
(B, nc, ...).

ops/substep_kernel.py launches the hand-written CUDA kernel for CUDA
tensors and calls ``pd_substeps_batched`` below for CPU tensors.

``engine_step_b`` / ``engine_forward_b`` at the end are the JAX package's
engine step (engine.step / engine.forward: mj_step / mj_forward) on the same
helpers, with its projected Jacobi contact solve in place of the kernels'
dense solve; the cartpole env and robots/pd.py run them, no kernel does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import engine as eng
from .engine import _tables
from .linalg_small import cho_solve_outer, cholesky_outer
from .model import FREE, HINGE, SLIDE, Contact, DynParams, Model, PhysicsState
from .spec import _quat_to_mat_np
from .motor import MotorState, motor_substep_torque_b
from . import maths
from .maths import cross

# preconditioned projected-refinement sweeps for the contact solve: one
# initial projection plus PROJ_REFINE_ITERS - 1 refinements
PROJ_REFINE_ITERS = 4
# projected-Jacobi sweeps for the dual contact solve of the engine step
SOLVER_ITERATIONS = 30
SOLVER_RELAXATION = 0.95


def _const(x, like: torch.Tensor) -> torch.Tensor:
    """Model constant rounded to float32, in ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=like.device, dtype=like.dtype)


# --------------------------------------------------------------------------
# kinematics / dynamics
# --------------------------------------------------------------------------


def fk_b(model: Model, qpos: torch.Tensor):
    """qpos (B, nq) -> xpos (B, nb, 3), xquat (B, nb, 4). A slide joint
    moves along its axis in the parent frame, as the JAX engine's fk and
    ``motion_subspace_b`` take it."""
    batch = qpos.shape[0]
    dev = qpos.device
    zero3 = torch.zeros((batch, 3), device=dev, dtype=qpos.dtype)
    ident = torch.zeros((batch, 4), device=dev, dtype=qpos.dtype)
    ident[:, 0] = 1.0
    xpos, xquat = [zero3], [ident]
    for i in range(1, model.nbody):
        p = model.body_parent[i]
        x_pre = xpos[p] + maths.quat_rotate(xquat[p], model.body_pos[i])
        q_pre = maths.quat_mul(xquat[p], model.body_quat[i])
        jt = model.jnt_type[i]
        adr = model.body_qpos_adr[i]
        if jt == FREE:
            x = qpos[:, adr : adr + 3]
            q = maths.quat_normalize(qpos[:, adr + 3 : adr + 7])
        elif jt == HINGE:
            half = 0.5 * qpos[:, adr]
            axis = model.jnt_axis[i]
            s = torch.sin(half)
            qj = torch.stack([torch.cos(half), axis[0] * s, axis[1] * s, axis[2] * s], dim=-1)
            q = maths.quat_mul(q_pre, qj)
            anchor = model.jnt_pos[i].expand(batch, 3)
            x = x_pre + maths.quat_rotate(q_pre, anchor) - maths.quat_rotate(q, anchor)
        elif jt == SLIDE:
            q = q_pre
            x = x_pre + maths.quat_rotate(q_pre, model.jnt_axis[i] * qpos[:, adr, None])
        else:
            q, x = q_pre, x_pre
        xpos.append(x)
        xquat.append(q)
    return torch.stack(xpos, dim=1), torch.stack(xquat, dim=1)


def motion_subspace_b(model: Model, xpos, rmats):
    """-> S (B, nv, 6): per-dof screw axes (angular, linear at world origin)."""
    t = _tables(model)
    batch = xpos.shape[0]
    dev = xpos.device
    rows = []
    fb = t["free_body"]
    if fb >= 0:
        rot = rmats[:, fb]  # (B, 3, 3)
        eye = torch.eye(3, device=dev)
        for k in range(3):
            rows.append(torch.cat([torch.zeros((batch, 3), device=dev), eye[k].expand(batch, 3)], dim=-1))
        for k in range(3):
            axis = rot[:, :, k]
            rows.append(torch.cat([axis, cross(xpos[:, fb], axis)], dim=-1))
    for n, bi in enumerate(t["j_body"]):
        bi = int(bi)
        rot = rmats[:, bi]
        a = model.jnt_axis[bi]
        pl = model.jnt_pos[bi]
        axis_w = a[0] * rot[:, :, 0] + a[1] * rot[:, :, 1] + a[2] * rot[:, :, 2]
        if t["j_is_hinge"][n] > 0.5:
            anchor = xpos[:, bi] + (pl[0] * rot[:, :, 0] + pl[1] * rot[:, :, 1] + pl[2] * rot[:, :, 2])
            rows.append(torch.cat([axis_w, cross(anchor, axis_w)], dim=-1))
        else:
            rows.append(torch.cat([torch.zeros_like(axis_w), axis_w], dim=-1))
    return torch.stack(rows, dim=1)


def body_velocities_b(model: Model, s_mat, qvel):
    """-> cvel (B, nb, 6): body spatial velocities from S and qvel."""
    anc = _const(_tables(model)["anc"], qvel)
    return torch.einsum("nv,bvs->bns", anc, s_mat * qvel[:, :, None])


def _skew(c):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    zero = torch.zeros_like(c[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -c[..., 2], c[..., 1]], dim=-1),
            torch.stack([c[..., 2], zero, -c[..., 0]], dim=-1),
            torch.stack([-c[..., 1], c[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def smooth_forces_b(model: Model, params: DynParams, qpos, qvel, xpos, xquat, rmats, ctrl):
    """Per-substep fresh half of the smooth dynamics.

    Returns (jac (B,nb,6,nv), s_mat (B,nv,6), cvel (B,nb,6),
    inertias (B,nb,6,6), qfrc_smooth (B,nv), act_force (B,nu))."""
    t = _tables(model)
    anc = _const(t["anc"], qvel)  # (nb, nv)

    s_mat = motion_subspace_b(model, xpos, rmats)
    sv = s_mat * qvel[:, :, None]
    cvel = torch.einsum("nv,bvs->bns", anc, sv)

    iq_mats = _const(np.stack([_quat_to_mat_np(q) for q in model.np("body_iquat")]), qvel)
    rot = torch.einsum("bnij,njk->bnik", rmats, iq_mats)
    mass_ratio = params.body_mass / torch.clamp_min(model.body_mass, 1e-9)[None]
    diag = model.body_inertia[None] * mass_ratio[..., None]
    i_com = torch.einsum("bnij,bnj,bnkj->bnik", rot, diag, rot)
    com = xpos + torch.einsum("bnij,bnj->bni", rmats, params.body_ipos)
    cx = _skew(com)
    m_ = params.body_mass[..., None, None]
    ibar = i_com - m_ * torch.einsum("bnij,bnjk->bnik", cx, cx)
    eye3 = torch.eye(3, device=qvel.device).expand(cx.shape)
    top = torch.cat([ibar, m_ * cx], dim=-1)
    bot = torch.cat([m_ * cx.transpose(-1, -2), m_ * eye3], dim=-1)
    inertias = torch.cat([top, bot], dim=-2)

    jac = s_mat.transpose(1, 2)[:, None] * anc[None, :, None, :]  # (B, nb, 6, nv)

    # bias forces (gravity trick: base acceleration = -g)
    v_dof = cvel[:, list(model.dof_body)]  # (B, nv, 6)
    cross_terms = maths.motion_cross(v_dof, sv)
    g = torch.cat([torch.zeros(3, device=qvel.device), -model.gravity])
    acc = g + torch.einsum("nv,bvs->bns", anc, cross_terms)
    momentum = torch.einsum("bnij,bnj->bni", inertias, cvel)
    f = torch.einsum("bnij,bnj->bni", inertias, acc) + maths.force_cross(cvel, momentum)
    qfrc_bias = torch.einsum("bnaj,bna->bj", jac, f)

    # actuation
    ctrl = torch.clamp(ctrl, model.actuator_ctrlrange[:, 0], model.actuator_ctrlrange[:, 1])
    act_force = model.actuator_gear * ctrl
    qfrc_act = torch.zeros_like(qvel)
    qfrc_act[:, list(model.actuator_dof)] = act_force

    qfrc_passive = -params.dof_frictionloss * torch.tanh(qvel / 0.02)
    qfrc_damp = -params.dof_damping * qvel

    xf = params.xfrc  # (B, nb, 6): (force, torque)
    moment = cross(xpos, xf[..., :3]) + xf[..., 3:]
    f_spatial = torch.cat([moment, xf[..., :3]], dim=-1)
    qfrc_xfrc = torch.einsum("bnaj,bna->bj", jac, f_spatial)

    qfrc_smooth = qfrc_act + qfrc_passive + qfrc_damp + qfrc_xfrc - qfrc_bias
    return jac, s_mat, cvel, inertias, qfrc_smooth, act_force


def factorize_b(model: Model, params: DynParams, jac, inertias, dt):
    """Refresh-time factorization: CRBA mass matrix + armature + implicit
    damping, then its Cholesky (B, nv, nv)."""
    m_mat = torch.einsum("bnaj,bnak,bnkl->bjl", jac, inertias, jac)
    m_mat = m_mat + torch.diag(model.dof_armature)
    mh = m_mat + dt * torch.diag_embed(params.dof_damping)
    return cholesky_outer(mh)


# --------------------------------------------------------------------------
# contacts: floor, heightfield, terrain boxes
# --------------------------------------------------------------------------


def detect_contacts_b(model: Model, xpos, xquat, rmats, terrain: eng.Terrain | None = None):
    """-> (cpos (B,nc,3), dist (B,nc), mask (B,nc), frame (B,nc,3,3)).

    Per foot geom, its 4 bottom corners against the floor: the z=0 plane
    without terrain, else the plane at floor_z or the heightfield surface
    (distance = vertical gap times the surface normal's z, tilted frame).
    Terrain-box models add the same 4 corners against the box SDF."""
    batch = xpos.shape[0]
    z_frame = _const(eng._Z_FRAME, xpos).expand(batch, 4, 3, 3)
    all_pos, all_dist, all_frame = [], [], []
    for gi in model.foot_geoms:
        bi = model.geom_body[gi]
        rot_b = rmats[:, bi]
        rot_g = torch.einsum("bij,jk->bik", rot_b, _const(_quat_to_mat_np(model.np("geom_quat")[gi]), xpos))
        gpos = xpos[:, bi] + torch.einsum("bij,j->bi", rot_b, model.geom_pos[gi])
        corners_l = _const(eng._BOTTOM_CORNERS * model.np("geom_size")[gi][None, :], xpos)
        cw = gpos[:, None] + torch.einsum("bij,cj->bci", rot_g, corners_l)  # (B, 4, 3)
        if terrain is None:
            floor_dist, ground_frame = cw[..., 2], z_frame
        elif terrain.hfield is not None:
            hz, hn = eng.hfield_query(terrain, cw[..., :2])
            floor_dist = (cw[..., 2] - (terrain.floor_z[:, None] + hz)) * hn[..., 2]
            ground_frame = eng.frame_from_normal(hn)
        else:
            floor_dist, ground_frame = cw[..., 2] - terrain.floor_z[:, None], z_frame
        all_pos.append(cw)
        all_dist.append(floor_dist)
        all_frame.append(ground_frame)
        if model.nterrain > 0:
            box_dist, normal = eng.terrain_contact(terrain, cw)
            all_pos.append(cw)
            all_dist.append(box_dist)
            all_frame.append(eng.frame_from_normal(normal))
    cpos = torch.cat(all_pos, dim=1)
    dist = torch.cat(all_dist, dim=1)
    frame = torch.cat(all_frame, dim=1)
    mask = (dist < eng.CONTACT_MARGIN).to(cpos.dtype)
    return cpos, dist, mask, frame


def contact_jacobian_b(model: Model, jac, cpos, cframe):
    """-> Jc (B, nc, 3, nv): contact-point velocity rows in the contact frame."""
    spg = eng.slots_per_geom(model)
    blocks = []
    slot = 0
    for gi in model.foot_geoms:
        bi = model.geom_body[gi]
        ang, lin = jac[:, bi, :3], jac[:, bi, 3:]  # (B, 3, nv)
        for _ in range(spg):
            p = cpos[:, slot, :, None]  # (B, 3, 1)
            jp = lin - torch.stack(
                [
                    p[:, 1] * ang[:, 2] - p[:, 2] * ang[:, 1],
                    p[:, 2] * ang[:, 0] - p[:, 0] * ang[:, 2],
                    p[:, 0] * ang[:, 1] - p[:, 1] * ang[:, 0],
                ],
                dim=1,
            )
            blocks.append(torch.einsum("bfi,biv->bfv", cframe[:, slot], jp))
            slot += 1
    return torch.stack(blocks, dim=1)


def dual_system_b(model: Model, qvel, jac, chol, qacc_smooth, cpos, dist, mask, cframe):
    """The regularized dual contact problem A f = b (MuJoCo-like soft
    constraints: impedance from solimp, reference acceleration from solref),
    masked slots deactivated with unit diagonal rows. Returns (Jc flat
    (B,3nc,nv), A (B,3nc,3nc), b (B,3nc), per-slot friction mu (nc,))."""
    nc = model.ncon
    batch = qvel.shape[0]
    jc = contact_jacobian_b(model, jac, cpos, cframe)  # (B, nc, 3, nv)
    jc_flat = jc.reshape(batch, 3 * nc, model.nv)
    minv_jt = cho_solve_outer(chol, jc_flat.transpose(1, 2))  # (B, nv, 3nc)
    a_mat = torch.einsum("biv,bvj->bij", jc_flat, minv_jt)  # (B, 3nc, 3nc)

    pen = torch.clamp_max(dist, 0.0)
    imp_min = float(model.np("imp_min"))
    imp_max = float(model.np("imp_max"))
    width = float(model.np("imp_width"))
    timeconst = float(model.np("timeconst"))
    dampratio = float(model.np("dampratio"))
    imp = imp_min + (imp_max - imp_min) * torch.clamp(-pen / width, 0.0, 1.0)
    k = 1.0 / max(imp_max**2 * timeconst**2 * dampratio**2, 1e-12)
    b_c = 2.0 / max(imp_max * timeconst, 1e-12)

    vel_c = torch.einsum("bcfv,bv->bcf", jc, qvel)
    aref = -b_c * vel_c
    aref = torch.cat([aref[..., :1] - (k * imp * pen)[..., None], aref[..., 1:]], dim=-1)

    diag_a = torch.diagonal(a_mat, dim1=-2, dim2=-1)
    r_reg = torch.repeat_interleave((1.0 - imp) / torch.clamp_min(imp, 1e-6), 3, dim=1)
    r_diag = r_reg * torch.clamp_min(diag_a, 1e-8)
    mask3 = torch.repeat_interleave(mask, 3, dim=1)
    a_mat = a_mat * (mask3[:, :, None] * mask3[:, None, :]) + torch.diag_embed(1.0 - mask3 + r_diag * mask3)

    b_vec = (aref.reshape(batch, 3 * nc) - torch.einsum("biv,bv->bi", jc_flat, qacc_smooth)) * mask3

    mu = _const(np.repeat(model.np("geom_friction")[list(model.foot_geoms)], eng.slots_per_geom(model)), qvel)
    return jc_flat, a_mat, b_vec, mu


def project_friction_cone(f, mu, mask):
    """Project stacked contact forces f (B, 3nc) onto {f_n >= 0,
    |f_t| <= mu f_n} per slot, masked slots zeroed."""
    batch, nc = f.shape[0], mu.shape[0]
    f3 = f.reshape(batch, nc, 3)
    fn = torch.clamp_min(f3[..., 0], 0.0)
    ft = f3[..., 1:]
    ft_norm = torch.sqrt(torch.sum(ft * ft, dim=-1)) + 1e-9
    scale = torch.clamp_max((mu * fn) / ft_norm, 1.0)
    f3 = torch.cat([fn[..., None], ft * scale[..., None]], dim=-1) * mask[..., None]
    return f3.reshape(batch, 3 * nc)


def constraint_solve_b(model: Model, qvel, jac, chol, qacc_smooth, cpos, dist, mask, cframe):
    """Soft-contact solve: Cholesky of the regularized dual as a
    preconditioner plus projected refinements. Returns (qacc (B,nv),
    force (B,nc,3))."""
    nc = model.ncon
    batch = qvel.shape[0]
    jc_flat, a_mat, b_vec, mu = dual_system_b(model, qvel, jac, chol, qacc_smooth, cpos, dist, mask, cframe)
    chol_a = cholesky_outer(a_mat)

    project = lambda f: project_friction_cone(f, mu, mask)
    force = project(cho_solve_outer(chol_a, b_vec))
    for _ in range(PROJ_REFINE_ITERS - 1):
        r = b_vec - torch.einsum("bij,bj->bi", a_mat, force)
        force = project(force + cho_solve_outer(chol_a, r))

    qfrc_con = torch.einsum("biv,bi->bv", jc_flat, force)
    qacc = qacc_smooth + cho_solve_outer(chol, qfrc_con)
    return qacc, force.reshape(batch, nc, 3)


# --------------------------------------------------------------------------
# integration + step
# --------------------------------------------------------------------------


def integrate_b(model: Model, qpos, qvel, dt):
    t = _tables(model)
    new_qpos = qpos.clone()
    if t["j_qpos"].size:
        new_qpos[:, t["j_qpos"]] = qpos[:, t["j_qpos"]] + dt * qvel[:, t["j_dof"]]
    fb = t["free_body"]
    if fb >= 0:
        qadr, dadr = model.body_qpos_adr[fb], model.body_dof_adr[fb]
        new_qpos[:, qadr : qadr + 3] = qpos[:, qadr : qadr + 3] + dt * qvel[:, dadr : dadr + 3]
        new_qpos[:, qadr + 3 : qadr + 7] = maths.quat_integrate(
            qpos[:, qadr + 3 : qadr + 7], qvel[:, dadr + 3 : dadr + 6], dt
        )
    return new_qpos


def step_b(model: Model, params: DynParams, qpos, qvel, ctrl, dt, terrain=None, cache=None):
    """One substep. Returns (qpos, qvel, qacc, act_force, cpos, dist, mask,
    force, frame, cache).

    cache: optional (jac, chol) from an earlier refresh substep. When given,
    the contact solve and both M-solves run against the LAGGED Cholesky and
    contact basis while FK, S, cvel, bias forces and contact offsets stay
    current (factorization reuse, lag error O(|qvel| R dt)). cache=None
    factorizes fresh (exact, R=1) and returns the new cache."""
    xpos, xquat = fk_b(model, qpos)
    rmats = maths.quat_to_mat(xquat)
    jac, s_mat, cvel, inertias, qfrc_smooth, act_force = smooth_forces_b(
        model, params, qpos, qvel, xpos, xquat, rmats, ctrl
    )
    if cache is None:
        cache = (jac, factorize_b(model, params, jac, inertias, dt))
    jac_c, chol = cache
    qacc_smooth = cho_solve_outer(chol, qfrc_smooth)
    cpos, dist, mask, cframe = detect_contacts_b(model, xpos, xquat, rmats, terrain)
    qacc, force = constraint_solve_b(model, qvel, jac_c, chol, qacc_smooth, cpos, dist, mask, cframe)
    qvel = qvel + dt * qacc
    # runaway guard: clamp far above physical speeds (NaN passes through)
    qvel = torch.clamp(qvel, -1e4, 1e4)
    qpos = integrate_b(model, qpos, qvel, dt)
    return qpos, qvel, qacc, act_force, cpos, dist, mask, force, cframe, cache


def valid_reuse(frame_skip: int, reuse_interval) -> int:
    """R must divide frame_skip; anything else falls back to 1 (exact)."""
    reuse = int(reuse_interval or 1)
    return reuse if (reuse >= 1 and frame_skip % reuse == 0) else 1


def pd_substeps_batched(
    model: Model,
    params: DynParams,
    physics: PhysicsState,
    target: torch.Tensor,  # (B, nu)
    frame_skip: int,
    sim_dt: float,
    terrain: eng.Terrain | None = None,
    settle: bool = False,
    reuse_interval: int = 1,
    motor=None,
):
    """frame_skip PD + physics substeps over a whole env batch.

    ``terrain`` (batch-leading) is required when the model has terrain
    boxes; a heightfield terrain goes with a box-free model. settle=True
    applies zero torque (reset settling). Substep 0 of every
    group of ``reuse_interval`` substeps refreshes the factorization; the
    rest reuse it. qacc, act_torque and the contact fields come from the
    last substep; FK caches are rebuilt at the final state.

    ``motor``: an optional (motor params, batch-leading MotorState) pair
    (robots/motor.py). Every substep's PD torque then passes through the
    learned motor hook before ``ctrl = tau / gear``, and the return value is
    (PhysicsState, MotorState). It runs at the R it is given (the kernel's
    wrapper pins 1 for motor steps, as the reference's kernel does)."""
    qpos, qvel = physics.qpos, physics.qvel
    reuse = valid_reuse(frame_skip, reuse_interval)
    gear = model.actuator_gear
    act_q = list(model.actuator_qpos)
    act_d = list(model.actuator_dof)
    if motor is not None:
        motor_params, mstate = motor
        qd_h, ct_h, count = mstate.qdot_hist, mstate.ctau_hist, mstate.count
    cache = None
    for sub in range(frame_skip):
        if settle:
            ctrl = torch.zeros_like(target)
        else:
            q = qpos[:, act_q]
            v = qvel[:, act_d]
            tau = params.kp * (target - q) - params.kd * v - params.bemf_gain * v
            if motor is not None:
                tau, qd_h, ct_h, count = motor_substep_torque_b(motor_params, qd_h, ct_h, count, v, tau)
            ctrl = tau / gear
        out = step_b(model, params, qpos, qvel, ctrl, sim_dt, terrain, cache=None if sub % reuse == 0 else cache)
        qpos, qvel, qacc, act_force, cpos, dist, mask, force, cframe, cache = out

    xpos, xquat = fk_b(model, qpos)
    rmats = maths.quat_to_mat(xquat)
    cvel = body_velocities_b(model, motion_subspace_b(model, xpos, rmats), qvel)
    batch = qpos.shape[0]
    contact = Contact(
        pos=cpos,
        frame=cframe.contiguous(),
        dist=dist,
        geom=torch.as_tensor(eng.slot_geoms(model), dtype=torch.int32, device=qpos.device).expand(batch, -1),
        force=force,
        mask=mask,
    )
    out = PhysicsState(
        qpos=qpos,
        qvel=qvel,
        qacc=qacc,
        act_torque=act_force,
        xpos=xpos,
        xquat=xquat,
        cvel=cvel,
        contact=contact,
        time=physics.time + frame_skip * sim_dt,
    )
    if motor is None:
        return out
    return out, MotorState(qdot_hist=qd_h, ctau_hist=ct_h, count=count)


# --------------------------------------------------------------------------
# the engine step (mj_step / mj_forward)
# --------------------------------------------------------------------------


def _kinematics_b(model: Model, qpos, qvel):
    """(xpos, xquat, cvel) at qpos, qvel."""
    xpos, xquat = fk_b(model, qpos)
    cvel = body_velocities_b(model, motion_subspace_b(model, xpos, maths.quat_to_mat(xquat)), qvel)
    return xpos, xquat, cvel


def _smooth_dynamics_b(model: Model, params: DynParams, state: PhysicsState, ctrl, dt):
    """Everything before the contact solve, from the state's FK caches:
    (jac, chol of M + dt diag(damping), qacc_smooth, act_force)."""
    rmats = maths.quat_to_mat(state.xquat)
    jac, _, _, inertias, qfrc_smooth, act_force = smooth_forces_b(
        model, params, state.qpos, state.qvel, state.xpos, state.xquat, rmats, ctrl
    )
    chol = factorize_b(model, params, jac, inertias, dt)
    return jac, chol, cho_solve_outer(chol, qfrc_smooth), act_force


def jacobi_solve_b(a_mat, b_vec, mu, mask, iterations: int = SOLVER_ITERATIONS):
    """Projected Jacobi iteration on the dual contact problem A f = b
    (B, 3nc): each sweep steps every row by its residual over its absolute
    row sum (a Gershgorin bound that keeps the iteration contractive for the
    coupled 4-corner foot systems), relaxed, then projects each slot onto
    its friction cone."""
    diag = torch.clamp_min(torch.sum(torch.abs(a_mat), dim=-1), 1e-8)
    f = torch.zeros_like(b_vec)
    for _ in range(iterations):
        r = b_vec - torch.einsum("bij,bj->bi", a_mat, f)
        f = project_friction_cone(f + SOLVER_RELAXATION * r / diag, mu, mask)
    return f


def _contacts_and_solve_b(model: Model, state: PhysicsState, jac, chol, qacc_smooth, terrain):
    """Contact detection at the state's pose and the Jacobi contact solve:
    (qacc (B, nv), Contact)."""
    batch, dev = state.qpos.shape[0], state.qpos.device
    if model.ncon == 0:
        empty = lambda *shape: torch.zeros((batch, 0) + shape, device=dev)
        return qacc_smooth, Contact(pos=empty(3), frame=empty(3, 3), dist=empty(), geom=empty().to(torch.int32),
                                    force=empty(3), mask=empty())
    rmats = maths.quat_to_mat(state.xquat)
    cpos, dist, mask, cframe = detect_contacts_b(model, state.xpos, state.xquat, rmats, terrain)
    jc_flat, a_mat, b_vec, mu = dual_system_b(model, state.qvel, jac, chol, qacc_smooth, cpos, dist, mask, cframe)
    force = jacobi_solve_b(a_mat, b_vec, mu, mask)
    qacc = qacc_smooth + cho_solve_outer(chol, torch.einsum("biv,bi->bv", jc_flat, force))
    geom = torch.as_tensor(eng.slot_geoms(model), dtype=torch.int32, device=dev).expand(batch, -1)
    contact = Contact(pos=cpos, frame=cframe, dist=dist, geom=geom, force=force.reshape(batch, model.ncon, 3), mask=mask)
    return qacc, contact


def engine_step_b(model: Model, params: DynParams, state: PhysicsState, ctrl, dt, terrain: eng.Terrain | None = None):
    """Advance every env by one ``dt`` (mj_step): ctrl (B, nu). Consumes the
    state's FK caches and refreshes them at the new state."""
    jac, chol, qacc_smooth, act_force = _smooth_dynamics_b(model, params, state, ctrl, dt)
    qacc, contact = _contacts_and_solve_b(model, state, jac, chol, qacc_smooth, terrain)
    # runaway guard: clamp far above physical speeds (NaN passes through)
    qvel = torch.clamp(state.qvel + dt * qacc, -1e4, 1e4)
    qpos = integrate_b(model, state.qpos, qvel, dt)
    xpos, xquat, cvel = _kinematics_b(model, qpos, qvel)
    return PhysicsState(qpos=qpos, qvel=qvel, qacc=qacc, act_torque=act_force, xpos=xpos, xquat=xquat, cvel=cvel,
                        contact=contact, time=state.time + dt)


def engine_forward_b(model: Model, params: DynParams, state: PhysicsState, dt, terrain: eng.Terrain | None = None):
    """Recompute the derived quantities without integrating (mj_forward):
    the FK caches from qpos, then qacc and the contacts at zero control."""
    xpos, xquat, cvel = _kinematics_b(model, state.qpos, state.qvel)
    state = dataclasses.replace(state, xpos=xpos, xquat=xquat, cvel=cvel)
    ctrl = torch.zeros((state.qpos.shape[0], model.nu), device=state.qpos.device)
    jac, chol, qacc_smooth, _ = _smooth_dynamics_b(model, params, state, ctrl, dt)
    qacc, contact = _contacts_and_solve_b(model, state, jac, chol, qacc_smooth, terrain)
    return dataclasses.replace(state, qacc=qacc, contact=contact, act_torque=torch.zeros_like(ctrl))
