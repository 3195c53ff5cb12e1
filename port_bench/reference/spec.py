"""Frozen copy of learninghumanoidwalking_tpu_torch/physics/spec.py at commit 9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f
(imports made relative), part of the benchmark's plain reference: it does
not follow later changes of the program. The original docstring follows.

Declarative robot specification and lowering to static Model arrays.

Copy of learninghumanoidwalking_tpu/physics/spec.py (pure numpy), kept in
the port so that it imports nothing of the JAX package; ``lower`` returns
the port's torch ``Model``. The JAX docstring follows.

This is the TPU-native replacement for the reference's model pipeline
(MJCF robot descriptions + dm_control mjcf surgery in
reference envs/{jvrc,h1}/gen_xml.py + MjSpec.compile in
reference envs/common/mujoco_env.py:24-26): robots are described as a
small Python tree of bodies/joints/geoms/actuators, and `lower()` compiles
that description into the flat arrays + static topology metadata the batched
JAX engine consumes. An MJCF exporter (physics/mjcf.py) lets us compile the
same spec with the real MuJoCo binary for golden-value tests, mirroring the
role of scripts/test_contact_behavior.py in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

import torch

from . import model as m


@dataclass
class Joint:
    jtype: str  # 'free' | 'hinge' | 'slide'
    name: str = ""
    axis: tuple = (0.0, 0.0, 1.0)
    pos: tuple = (0.0, 0.0, 0.0)
    damping: float = 0.0
    armature: float = 0.0
    frictionloss: float = 0.0


@dataclass
class Geom:
    gtype: str  # 'plane' | 'sphere' | 'capsule' | 'box'
    size: tuple  # plane: unused; sphere: (r,); capsule: (r, half_len); box: half-sizes
    name: str = ""
    pos: tuple = (0.0, 0.0, 0.0)
    quat: tuple = (1.0, 0.0, 0.0, 0.0)
    friction: float = 1.0
    density: float = 1000.0  # used only when the body has no explicit mass
    contact: str = "none"  # 'none' | 'foot' | 'self'


@dataclass
class Body:
    name: str
    parent: str  # parent body name ('world' for root)
    pos: tuple = (0.0, 0.0, 0.0)
    quat: tuple = (1.0, 0.0, 0.0, 0.0)
    joint: Joint | None = None
    geoms: list = field(default_factory=list)
    # Explicit inertial properties. If mass is None they are derived from geoms
    # (the inertiafromgeom path, used by the cartpole model like the
    # reference's cartpole.xml `compiler inertiafromgeom='true'`).
    mass: float | None = None
    ipos: tuple = (0.0, 0.0, 0.0)
    inertia: tuple | None = None  # diagonal (ixx, iyy, izz) in inertial frame
    iquat: tuple = (1.0, 0.0, 0.0, 0.0)


@dataclass
class Actuator:
    joint: str
    gear: float = 1.0
    ctrlrange: tuple | None = None  # None = unlimited


@dataclass
class RobotSpec:
    name: str
    bodies: list  # Body list, parents must precede children
    actuators: list  # Actuator list
    # pairs of geom names checked for self-collision (boolean, sphere proxies)
    self_collision_pairs: list = field(default_factory=list)
    # geom names of the left / right foot collision boxes
    left_foot_geoms: list = field(default_factory=list)
    right_foot_geoms: list = field(default_factory=list)
    gravity: tuple = (0.0, 0.0, -9.81)
    # MuJoCo-like soft contact parameters (solref / solimp defaults)
    timeconst: float = 0.02
    dampratio: float = 1.0
    imp_min: float = 0.9
    imp_max: float = 0.95
    imp_width: float = 0.001
    # number of terrain box slots (for stepping-task style terrain)
    nterrain: int = 0


# --- inertia-from-geom helpers (MuJoCo inertiafromgeom semantics) -----------


def geom_mass_inertia(g: Geom) -> tuple[float, np.ndarray]:
    """Mass and diagonal inertia about the geom frame origin-at-CoM."""
    if g.gtype == "box":
        sx, sy, sz = (2 * s for s in g.size)  # full extents
        mass = g.density * sx * sy * sz
        inertia = (
            mass
            / 12.0
            * np.array([sy**2 + sz**2, sx**2 + sz**2, sx**2 + sy**2])
        )
    elif g.gtype == "sphere":
        r = g.size[0]
        mass = g.density * 4.0 / 3.0 * math.pi * r**3
        inertia = np.full(3, 0.4 * mass * r**2)
    elif g.gtype == "capsule":
        r, hl = g.size[0], g.size[1]
        l = 2 * hl
        m_cyl = g.density * math.pi * r**2 * l
        m_sph = g.density * 4.0 / 3.0 * math.pi * r**3
        mass = m_cyl + m_sph
        # cylinder about its center (axis = z)
        i_ax = 0.5 * m_cyl * r**2 + 0.4 * m_sph * r**2
        # perpendicular: cylinder + two half-spheres offset at +-hl
        i_perp_cyl = m_cyl * (l**2 / 12.0 + r**2 / 4.0)
        # half-sphere about capsule center: 0.4*m_half*r^2 + m_half*(hl + 3r/8)^2 approx
        m_half = m_sph / 2.0
        i_perp_sph = 2 * (0.4 * m_half * r**2 + m_half * (hl + 3.0 * r / 8.0) ** 2)
        i_perp = i_perp_cyl + i_perp_sph
        inertia = np.array([i_perp, i_perp, i_ax])
    else:
        raise ValueError(f"cannot derive inertia for geom type {g.gtype}")
    return float(mass), inertia


def _quat_to_mat_np(q) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _body_inertial_from_geoms(body: Body) -> tuple[float, np.ndarray, np.ndarray]:
    """Aggregate (mass, com, diag inertia about com in body axes) from geoms."""
    parts = []
    for g in body.geoms:
        if g.gtype == "plane":
            continue
        mass, diag = geom_mass_inertia(g)
        rot = _quat_to_mat_np(g.quat)
        inertia = rot @ np.diag(diag) @ rot.T
        parts.append((mass, np.asarray(g.pos, dtype=np.float64), inertia))
    if not parts:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    total = sum(p[0] for p in parts)
    com = sum(p[0] * p[1] for p in parts) / total
    inertia = np.zeros((3, 3))
    for mass, pos, i_g in parts:
        r = pos - com
        inertia += i_g + mass * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
    return total, com, inertia


def _diagonalize(inertia: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (diag, iquat) such that R(iquat) diag R(iquat)^T = inertia."""
    vals, vecs = np.linalg.eigh(inertia)
    if np.linalg.det(vecs) < 0:
        vecs[:, 0] = -vecs[:, 0]
    # rotation matrix -> quaternion
    t = np.trace(vecs)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        quat = np.array(
            [0.25 * s, (vecs[2, 1] - vecs[1, 2]) / s, (vecs[0, 2] - vecs[2, 0]) / s, (vecs[1, 0] - vecs[0, 1]) / s]
        )
    else:
        i = int(np.argmax(np.diag(vecs)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(1.0 + vecs[i, i] - vecs[j, j] - vecs[k, k], 1e-12)) * 2
        quat = np.zeros(4)
        quat[0] = (vecs[k, j] - vecs[j, k]) / s
        quat[1 + i] = 0.25 * s
        quat[1 + j] = (vecs[j, i] + vecs[i, j]) / s
        quat[1 + k] = (vecs[k, i] + vecs[i, k]) / s
    quat = quat / np.linalg.norm(quat)
    return np.maximum(vals, 1e-9), quat


def lower(spec: RobotSpec, device: str | torch.device = "cpu") -> m.Model:
    """Compile a RobotSpec into a Model of flat arrays + static metadata,
    with the arrays as float32 tensors on ``device``."""
    names = [b.name for b in spec.bodies]
    if len(set(names)) != len(names):
        raise ValueError("duplicate body names")
    name_to_idx = {"world": 0}

    nb = len(spec.bodies) + 1  # + world body at index 0
    body_parent = [-1]
    jnt_type = [-1]
    body_qpos_adr = [-1]
    body_dof_adr = [-1]
    body_dof_num = [0]
    joint_names = [""]
    body_pos = [np.zeros(3)]
    body_quat = [np.array([1.0, 0, 0, 0])]
    body_ipos = [np.zeros(3)]
    body_iquat = [np.array([1.0, 0, 0, 0])]
    body_mass = [0.0]
    body_inertia = [np.zeros(3)]
    jnt_axis = [np.zeros(3)]
    jnt_pos = [np.zeros(3)]

    dof_body: list[int] = []
    dof_armature: list[float] = []
    dof_damping: list[float] = []
    dof_frictionloss: list[float] = []
    joint_to_body: dict[str, int] = {}

    nq = 0
    for i, b in enumerate(spec.bodies, start=1):
        if b.parent not in name_to_idx:
            raise ValueError(f"body {b.name}: parent {b.parent} must be defined first")
        name_to_idx[b.name] = i
        body_parent.append(name_to_idx[b.parent])
        body_pos.append(np.asarray(b.pos, dtype=np.float64))
        body_quat.append(np.asarray(b.quat, dtype=np.float64))

        # inertial properties
        if b.mass is not None:
            mass = b.mass
            ipos = np.asarray(b.ipos, dtype=np.float64)
            if b.inertia is None:
                raise ValueError(f"body {b.name}: explicit mass requires explicit inertia")
            diag = np.asarray(b.inertia, dtype=np.float64)
            iquat = np.asarray(b.iquat, dtype=np.float64)
        else:
            mass, ipos, inertia_mat = _body_inertial_from_geoms(b)
            diag, iquat = _diagonalize(inertia_mat)
        body_mass.append(float(mass))
        body_ipos.append(ipos)
        body_inertia.append(diag)
        body_iquat.append(iquat)

        j = b.joint
        if j is None:
            jnt_type.append(-1)
            body_qpos_adr.append(-1)
            body_dof_adr.append(-1)
            body_dof_num.append(0)
            joint_names.append("")
            jnt_axis.append(np.zeros(3))
            jnt_pos.append(np.zeros(3))
            continue

        jname = j.name or f"{b.name}_joint"
        joint_names.append(jname)
        joint_to_body[jname] = i
        jnt_pos.append(np.asarray(j.pos, dtype=np.float64))
        axis = np.asarray(j.axis, dtype=np.float64)
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        jnt_axis.append(axis)
        if j.jtype == "free":
            if i != 1:
                raise ValueError("free joint only supported on the first (root) body")
            jnt_type.append(m.FREE)
            body_qpos_adr.append(nq)
            body_dof_adr.append(len(dof_body))
            body_dof_num.append(6)
            nq += 7
            for _ in range(6):
                dof_body.append(i)
                dof_armature.append(0.0)
                dof_damping.append(0.0)
                dof_frictionloss.append(0.0)
        elif j.jtype in ("hinge", "slide"):
            jnt_type.append(m.HINGE if j.jtype == "hinge" else m.SLIDE)
            body_qpos_adr.append(nq)
            body_dof_adr.append(len(dof_body))
            body_dof_num.append(1)
            nq += 1
            dof_body.append(i)
            dof_armature.append(j.armature)
            dof_damping.append(j.damping)
            dof_frictionloss.append(j.frictionloss)
        else:
            raise ValueError(f"unknown joint type {j.jtype}")

    nv = len(dof_body)

    # geoms ------------------------------------------------------------------
    geom_body: list[int] = []
    geom_type: list[int] = []
    geom_names: list[str] = []
    geom_pos: list[np.ndarray] = []
    geom_quat: list[np.ndarray] = []
    geom_size: list[np.ndarray] = []
    geom_friction: list[float] = []
    gtype_codes = {"plane": m.PLANE, "sphere": m.SPHERE, "capsule": m.CAPSULE, "box": m.BOX}
    for b in spec.bodies:
        bi = name_to_idx[b.name]
        for g in b.geoms:
            geom_body.append(bi)
            geom_type.append(gtype_codes[g.gtype])
            geom_names.append(g.name or f"{b.name}_geom{len(geom_names)}")
            geom_pos.append(np.asarray(g.pos, dtype=np.float64))
            geom_quat.append(np.asarray(g.quat, dtype=np.float64))
            size = np.zeros(3)
            size[: len(g.size)] = g.size
            geom_size.append(size)
            geom_friction.append(g.friction)
    gname_to_idx = {n: i for i, n in enumerate(geom_names)}

    left = tuple(gname_to_idx[n] for n in spec.left_foot_geoms)
    right = tuple(gname_to_idx[n] for n in spec.right_foot_geoms)
    foot_geoms = left + right
    self_pairs = tuple((gname_to_idx[a], gname_to_idx[b]) for a, b in spec.self_collision_pairs)

    # 4 bottom-corner slots per foot geom vs the floor plane (static corner
    # set; engine._BOTTOM_CORNERS). Terrain models add a second slot per
    # corner for the terrain-box SDF (top + side faces), mirroring MuJoCo's
    # separate plane-box and box-box contacts (engine.slots_per_geom).
    ncon = (4 if spec.nterrain == 0 else 8) * len(foot_geoms)

    # actuators ---------------------------------------------------------------
    act_body, act_dof, act_qpos, act_gear, act_range, act_names = [], [], [], [], [], []
    for a in spec.actuators:
        bi = joint_to_body[a.joint]
        if body_dof_num[bi] != 1:
            raise ValueError(f"actuator on multi-dof joint {a.joint} unsupported")
        act_body.append(bi)
        act_dof.append(body_dof_adr[bi])
        act_qpos.append(body_qpos_adr[bi])
        act_gear.append(a.gear)
        act_range.append(a.ctrlrange if a.ctrlrange is not None else (-np.inf, np.inf))
        act_names.append(a.joint)
    nu = len(act_body)

    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    return m.Model(
        nq=nq,
        nv=nv,
        nu=nu,
        nbody=nb,
        ngeom=len(geom_body),
        body_parent=tuple(body_parent),
        jnt_type=tuple(jnt_type),
        body_qpos_adr=tuple(body_qpos_adr),
        body_dof_adr=tuple(body_dof_adr),
        body_dof_num=tuple(body_dof_num),
        dof_body=tuple(dof_body),
        body_names=("world", *names),
        joint_names=tuple(joint_names),
        actuator_names=tuple(act_names),
        geom_names=tuple(geom_names),
        actuator_body=tuple(act_body),
        actuator_dof=tuple(act_dof),
        actuator_qpos=tuple(act_qpos),
        geom_body=tuple(geom_body),
        geom_type=tuple(geom_type),
        foot_geoms=foot_geoms,
        left_foot_geoms=left,
        right_foot_geoms=right,
        self_pairs=self_pairs,
        ncon=ncon,
        nterrain=spec.nterrain,
        body_pos=f32(np.stack(body_pos)),
        body_quat=f32(np.stack(body_quat)),
        body_ipos=f32(np.stack(body_ipos)),
        body_iquat=f32(np.stack(body_iquat)),
        body_mass=f32(body_mass),
        body_inertia=f32(np.stack(body_inertia)),
        jnt_axis=f32(np.stack(jnt_axis)),
        jnt_pos=f32(np.stack(jnt_pos)),
        dof_armature=f32(dof_armature),
        dof_damping=f32(dof_damping),
        dof_frictionloss=f32(dof_frictionloss),
        actuator_gear=f32(act_gear),
        actuator_ctrlrange=f32(np.asarray(act_range).reshape(nu, 2) if nu else np.zeros((0, 2))),
        geom_pos=f32(np.stack(geom_pos) if geom_body else np.zeros((0, 3))),
        geom_quat=f32(np.stack(geom_quat) if geom_body else np.zeros((0, 4))),
        geom_size=f32(np.stack(geom_size) if geom_body else np.zeros((0, 3))),
        geom_friction=f32(geom_friction if geom_body else np.zeros((0,))),
        timeconst=f32(spec.timeconst),
        dampratio=f32(spec.dampratio),
        imp_min=f32(spec.imp_min),
        imp_max=f32(spec.imp_max),
        imp_width=f32(spec.imp_width),
        gravity=f32(spec.gravity),
    )
