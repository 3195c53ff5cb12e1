"""Frozen copy of learninghumanoidwalking_tpu_torch/physics/model.py at commit 9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f
(imports made relative), part of the benchmark's plain reference: it does
not follow later changes of the program. The original docstring follows.

Core physics data structures (counterpart of learninghumanoidwalking_tpu/physics/model.py).

``Model`` is the static robot description: structural metadata as Python
tuples and array data as float32 tensors on one device. ``DynParams`` is the
per-env domain-randomization surface and ``PhysicsState`` the MjData-like
state with its forward caches. All per-env tensors are batch-LEADING:
(B, ...) where the JAX package holds one env per vmapped call.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from .maths import cross

# Joint type codes.
FREE = 0
HINGE = 1
SLIDE = 2

# Geom type codes.
PLANE = 0
SPHERE = 1
CAPSULE = 2
BOX = 3

_STATIC_FIELDS = (
    "nq", "nv", "nu", "nbody", "ngeom", "body_parent", "jnt_type", "body_qpos_adr",
    "body_dof_adr", "body_dof_num", "dof_body", "body_names", "joint_names",
    "actuator_names", "geom_names", "actuator_body", "actuator_dof", "actuator_qpos",
    "geom_body", "geom_type", "foot_geoms", "left_foot_geoms", "right_foot_geoms",
    "self_pairs", "ncon", "nterrain",
)


@dataclasses.dataclass(frozen=True)
class Model:
    """Static physics model; see the JAX Model for the meaning of each field."""

    nq: int
    nv: int
    nu: int
    nbody: int
    ngeom: int
    body_parent: tuple
    jnt_type: tuple
    body_qpos_adr: tuple
    body_dof_adr: tuple
    body_dof_num: tuple
    dof_body: tuple
    body_names: tuple
    joint_names: tuple
    actuator_names: tuple
    geom_names: tuple
    actuator_body: tuple
    actuator_dof: tuple
    actuator_qpos: tuple
    geom_body: tuple
    geom_type: tuple
    foot_geoms: tuple
    left_foot_geoms: tuple
    right_foot_geoms: tuple
    self_pairs: tuple
    ncon: int
    nterrain: int

    body_pos: torch.Tensor  # (nb, 3)
    body_quat: torch.Tensor  # (nb, 4)
    body_ipos: torch.Tensor  # (nb, 3)
    body_iquat: torch.Tensor  # (nb, 4)
    body_mass: torch.Tensor  # (nb,)
    body_inertia: torch.Tensor  # (nb, 3)
    jnt_axis: torch.Tensor  # (nb, 3)
    jnt_pos: torch.Tensor  # (nb, 3)
    dof_armature: torch.Tensor  # (nv,)
    dof_damping: torch.Tensor  # (nv,)
    dof_frictionloss: torch.Tensor  # (nv,)
    actuator_gear: torch.Tensor  # (nu,)
    actuator_ctrlrange: torch.Tensor  # (nu, 2)
    geom_pos: torch.Tensor  # (ng, 3)
    geom_quat: torch.Tensor  # (ng, 4)
    geom_size: torch.Tensor  # (ng, 3)
    geom_friction: torch.Tensor  # (ng,)
    timeconst: torch.Tensor  # ()
    dampratio: torch.Tensor  # ()
    imp_min: torch.Tensor  # ()
    imp_max: torch.Tensor  # ()
    imp_width: torch.Tensor  # ()
    gravity: torch.Tensor  # (3,)

    @property
    def device(self) -> torch.device:
        return self.body_mass.device

    @functools.cached_property
    def host(self) -> dict:
        """Host numpy copies of every array field, read once per model so
        that table building never syncs with the device again."""
        return {
            f.name: getattr(self, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(self)
            if f.name not in _STATIC_FIELDS
        }

    def np(self, name: str) -> np.ndarray:
        """Host copy of an array field (static constants for table building)."""
        return self.host[name]


@dataclasses.dataclass
class DynParams:
    """Per-env dynamic parameters, batch-leading (B, ...)."""

    dof_damping: torch.Tensor  # (B, nv)
    dof_frictionloss: torch.Tensor  # (B, nv)
    body_mass: torch.Tensor  # (B, nb)
    body_ipos: torch.Tensor  # (B, nb, 3)
    xfrc: torch.Tensor  # (B, nb, 6) applied world wrench (force(3), torque(3))
    kp: torch.Tensor  # (B, nu)
    kd: torch.Tensor  # (B, nu)
    bemf_gain: torch.Tensor  # (B, nu)


def default_dyn_params(model: Model, kp, kd, batch: int) -> DynParams:
    """Model-default dynamics for ``batch`` envs (the JAX version, broadcast)."""
    dev = model.device
    rep = lambda x: x[None].expand((batch,) + tuple(x.shape)).clone()
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return DynParams(
        dof_damping=rep(model.dof_damping),
        dof_frictionloss=rep(model.dof_frictionloss),
        body_mass=rep(model.body_mass),
        body_ipos=rep(model.body_ipos),
        xfrc=torch.zeros((batch, model.nbody, 6), device=dev),
        kp=rep(as_t(kp)),
        kd=rep(as_t(kd)),
        bemf_gain=torch.zeros((batch, model.nu), device=dev),
    )


@dataclasses.dataclass
class Contact:
    """Fixed-size contact buffer, batch-leading; ``mask`` marks live slots."""

    pos: torch.Tensor  # (B, nc, 3)
    frame: torch.Tensor  # (B, nc, 3, 3) rows = (normal, tangent1, tangent2)
    dist: torch.Tensor  # (B, nc)
    geom: torch.Tensor  # (B, nc) int
    force: torch.Tensor  # (B, nc, 3) in the contact frame (n, t1, t2)
    mask: torch.Tensor  # (B, nc)


@dataclasses.dataclass
class PhysicsState:
    """Dynamic state + forward caches, batch-leading."""

    qpos: torch.Tensor  # (B, nq)
    qvel: torch.Tensor  # (B, nv)
    qacc: torch.Tensor  # (B, nv)
    act_torque: torch.Tensor  # (B, nu)
    xpos: torch.Tensor  # (B, nb, 3)
    xquat: torch.Tensor  # (B, nb, 4)
    cvel: torch.Tensor  # (B, nb, 6) (omega, v at world origin)
    contact: Contact
    time: torch.Tensor  # (B,)

    def body_vel_world(self, body: int) -> torch.Tensor:
        """(B, 3) linear velocity of a body frame origin, world frame."""
        w, v0 = self.cvel[:, body, :3], self.cvel[:, body, 3:]
        return v0 + cross(w, self.xpos[:, body])


def tree_map(fn, *trees: Any) -> Any:
    """Apply ``fn`` leafwise over matching dataclass / tuple / dict trees of
    tensors (None leaves pass through)."""
    first = trees[0]
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(
            first,
            **{f.name: tree_map(fn, *(getattr(t, f.name) for t in trees)) for f in dataclasses.fields(first)},
        )
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)
