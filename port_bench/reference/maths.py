"""Frozen copy of learninghumanoidwalking_tpu_torch/utils/maths.py at commit 9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f
(imports made relative), part of the benchmark's plain reference: it does
not follow later changes of the program. The original docstring follows.

Quaternion / rotation math (counterpart of learninghumanoidwalking_tpu/utils/maths.py).

Quaternions are wxyz (MuJoCo convention). Every function takes tensors with
the component axis LAST and any number of leading batch axes, which is what
JAX's per-env functions become once ``vmap`` is written out.
"""

from __future__ import annotations

import math

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis (explicit formula, same rounding as the JAX twin)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 (wxyz)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), min=eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (body -> world if q is the body orientation)."""
    qv = q[..., 1:]
    t = 2.0 * cross(qv, v)
    return v + q[..., :1] * t + cross(qv, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt: float) -> torch.Tensor:
    """q * exp(0.5 dt omega_local), renormalized (MuJoCo free-joint semantics)."""
    angle = torch.sqrt(torch.sum(omega_local * omega_local, dim=-1)) * dt
    half = 0.5 * angle
    s = 0.5 * dt * torch.sinc(half / math.pi)
    dq = torch.cat([torch.cos(half)[..., None], s[..., None] * omega_local], dim=-1)
    return quat_normalize(quat_mul(q, dq))


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-y-z (roll, pitch, yaw), transforms3d 'sxyz' convention."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - x * z), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    hr, hp, hy = (rpy[..., i] / 2.0 for i in range(3))
    cr, sr = torch.cos(hr), torch.sin(hr)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cy, sy = torch.cos(hy), torch.sin(hy)
    return torch.stack(
        [
            cr * cp * cy - sr * sp * sy,
            sr * cp * cy + cr * sp * sy,
            cr * sp * cy - sr * cp * sy,
            cr * cp * sy + sr * sp * cy,
        ],
        dim=-1,
    )


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m for motion vectors (w, v0), last axis 6."""
    w, v0 = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, mv) + cross(v0, mw)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f for force vectors (n, f_lin), last axis 6."""
    w, v0 = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(v0, fl), cross(w, fl)], dim=-1)
