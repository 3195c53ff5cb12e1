"""Rangefinder sensor array: a grid of downward rays under the root body
(counterpart of learninghumanoidwalking_tpu/physics/rangefinder.py, over a
batch of envs).

The reference robots carry an optional num_rows x num_cols grid of MuJoCo
rangefinder sites on the pelvis, each pointing down in the pelvis frame.
Every shipped config leaves it off and nothing reads it; this is the same
capability as plain tensor code: rays cast against the floor plane and the
terrain boxes, the scene geometry of the engine's contacts. As in the JAX
function, a heightfield terrain is seen as its floor plane at ``floor_z``
(its heights are not cast against). MuJoCo's rangefinder semantics:
distance from the site along its ray to the nearest surface, -1 where
nothing is hit within ``max_range``.
"""

from __future__ import annotations

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.physics.engine import Terrain
from learninghumanoidwalking_tpu_torch.utils import maths


def site_grid(num_rows: int = 4, num_cols: int = 4, spacing: float = 0.4) -> np.ndarray:
    """(N, 3) site offsets in the root body's frame, N = rows x cols."""
    sites = []
    for i in range(num_rows * num_cols):
        u = i % num_cols
        v = i // num_rows
        x = (v - (num_cols - 1) / 2) * spacing
        y = ((num_rows - 1) / 2 - u) * (-spacing)
        sites.append((x, y, 0.0))
    return np.asarray(sites, dtype=np.float32)


def _ray_boxes(origins: torch.Tensor, direction: torch.Tensor, terrain: Terrain) -> torch.Tensor:
    """Slab method, rays (B, N) from ``origins`` (B, N, 3) along
    ``direction`` (B, 3) against every yaw-rotated box of the env: the least
    t >= 0 per ray and box (the exit face from inside a box), inf where the
    ray misses; (B, N, nt)."""
    c, s = torch.cos(terrain.yaw)[:, None], torch.sin(terrain.yaw)[:, None]  # (B, 1, nt)
    d = origins[:, :, None, :] - terrain.pos[:, None]  # (B, N, nt, 3)
    o_l = torch.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1], d[..., 2]], dim=-1)
    dx, dy, dz = (direction[:, None, None, k] for k in range(3))
    dir_l = torch.stack([c * dx + s * dy, -s * dx + c * dy, dz.expand_as(c)], dim=-1)  # (B, 1, nt, 3)
    inv = 1.0 / torch.where(dir_l.abs() < 1e-9, torch.sign(dir_l) * 1e-9 + 1e-12, dir_l)
    size = terrain.size[:, None]
    t1, t2 = (-size - o_l) * inv, (size - o_l) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = tmax >= torch.clamp_min(tmin, 0.0)
    t = torch.where(tmin >= 0.0, tmin, tmax)
    return torch.where(hit & (t >= 0.0), t, torch.inf)


def rangefinder(
    root_pos: torch.Tensor,
    root_quat: torch.Tensor,
    terrain: Terrain | None,
    sites: np.ndarray,
    max_range: float = 10.0,
) -> torch.Tensor:
    """(B, N) ray distances for the site grid, -1 where nothing is hit.

    Rays start at root_pos + R(root_quat) site and point along the root
    body's -z axis; ``root_pos`` (B, 3), ``root_quat`` (B, 4), ``terrain``
    batch-leading or None (the floor plane z = 0)."""
    n, dev, dt = root_pos.shape[0], root_pos.device, root_pos.dtype
    site_t = torch.as_tensor(sites, dtype=dt, device=dev)
    origins = root_pos[:, None] + maths.quat_rotate(root_quat[:, None], site_t.expand(n, -1, -1))
    direction = maths.quat_rotate(root_quat, torch.tensor([0.0, 0.0, -1.0], dtype=dt, device=dev).expand(n, 3))
    floor_z = terrain.floor_z if terrain is not None else torch.zeros(n, dtype=dt, device=dev)
    denom = torch.where(direction[:, 2].abs() < 1e-9, torch.full_like(direction[:, 2], -1e-9), direction[:, 2])
    t_floor = (floor_z[:, None] - origins[..., 2]) / denom[:, None]
    t = torch.where(t_floor >= 0.0, t_floor, torch.inf)
    if terrain is not None and terrain.pos.shape[1] > 0:
        t = torch.minimum(t, torch.amin(_ray_boxes(origins, direction, terrain), dim=-1))
    return torch.where(t <= max_range, t, torch.full_like(t, -1.0))
