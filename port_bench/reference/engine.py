"""Frozen copy of learninghumanoidwalking_tpu_torch/physics/engine.py at commit 9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f
(imports made relative), part of the benchmark's plain reference: it does
not follow later changes of the program. The original docstring follows.

Engine tables, contact constants, terrain and its point queries, state
construction and self-collision (the tables and queries of
learninghumanoidwalking_tpu/physics/engine.py).

The JAX package's engine step (``engine.step`` / ``engine.forward``, with
its projected Jacobi contact solve) lives batch-leading in
physics/batched.py as ``engine_step_b`` / ``engine_forward_b``, beside the
helpers it shares with the kernels' plain version. The terrain queries here
take a batch of envs with K query points each, where the JAX versions take
one env and one point.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .model import FREE, HINGE, SLIDE, Contact, Model, PhysicsState
from . import maths

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


@dataclasses.dataclass
class Terrain:
    """Per-env terrain, world frame, batch-leading: boxes and/or a
    heightfield (the JAX Terrain holds one env).

    Feet collide with box top AND side faces (terrain_contact). The optional
    heightfield is a regular (H, W) grid of heights relative to floor_z,
    interpolated bilinearly; it replaces the floor plane in the floor
    contact slots. ``hfield`` None means a flat floor at floor_z."""

    pos: torch.Tensor  # (B, nt, 3) box centres
    size: torch.Tensor  # (B, nt, 3) box half-sizes
    yaw: torch.Tensor  # (B, nt) rotation about z
    floor_z: torch.Tensor  # (B,) floor plane height
    hfield: torch.Tensor | None = None  # (B, H, W) heights above floor_z; [i, j] = node (x_j, y_i)
    hfield_x0y0: torch.Tensor | None = None  # (B, 2) world xy of node [0, 0]
    hfield_cell: torch.Tensor | None = None  # (B, 2) node spacing (dx, dy)


def _hfield_sample(grid: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of grid (B, H, W) at fractional node indices
    u (along W) and v (along H), (B, K), inside [0, W-1] x [0, H-1].

    The JAX package contracts the tent weights max(0, 1 - |i - u|) over the
    whole grid; they are non-zero only at the two nodes around u, so this
    reads those nodes and weighs them the same way, W first, then H. At
    u = W-1 the index is clamped to W-2 (weights 0 and 1), so no read
    passes the row. A NaN index reads node 0 and the NaN weights carry on."""
    batch, hgt, wid = grid.shape
    j0 = torch.nan_to_num(torch.floor(u)).clamp(0, wid - 2)
    i0 = torch.nan_to_num(torch.floor(v)).clamp(0, hgt - 2)
    wu0, wu1 = (torch.clamp_min(1.0 - torch.abs(j - u), 0.0) for j in (j0, j0 + 1.0))
    wv0, wv1 = (torch.clamp_min(1.0 - torch.abs(i - v), 0.0) for i in (i0, i0 + 1.0))
    flat = grid.reshape(batch, hgt * wid)
    idx = (i0 * wid + j0).long().reshape(batch, -1)

    def node(off: int) -> torch.Tensor:
        return torch.gather(flat, 1, idx + off).reshape(u.shape)

    row0 = wu0 * node(0) + wu1 * node(1)
    row1 = wu0 * node(wid) + wu1 * node(wid + 1)
    return wv0 * row0 + wv1 * row1


def hfield_query(terrain: Terrain, xy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Heightfield surface under world xy (B, K, 2): (height above floor_z
    (B, K), unit normal (B, K, 3)). The normal comes from central
    differences at quarter-cell offsets over the actual span, which the
    grid edge clips, so the slope stays unbiased there."""
    grid = terrain.hfield
    hgt, wid = grid.shape[1], grid.shape[2]
    x0y0, cell = terrain.hfield_x0y0[:, None], terrain.hfield_cell[:, None]  # (B, 1, 2)
    u = torch.clamp((xy[..., 0] - x0y0[..., 0]) / cell[..., 0], 0.0, wid - 1.0)
    v = torch.clamp((xy[..., 1] - x0y0[..., 1]) / cell[..., 1], 0.0, hgt - 1.0)
    h = _hfield_sample(grid, u, v)
    e = 0.25
    up, um = torch.clamp(u + e, 0.0, wid - 1.0), torch.clamp(u - e, 0.0, wid - 1.0)
    vp, vm = torch.clamp(v + e, 0.0, hgt - 1.0), torch.clamp(v - e, 0.0, hgt - 1.0)
    dh_dx = (_hfield_sample(grid, up, v) - _hfield_sample(grid, um, v)) / ((up - um) * cell[..., 0])
    dh_dy = (_hfield_sample(grid, u, vp) - _hfield_sample(grid, u, vm)) / ((vp - vm) * cell[..., 1])
    n = torch.stack([-dh_dx, -dh_dy, torch.ones_like(h)], dim=-1)
    return h, n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))


def _box_local(terrain: Terrain, p: torch.Tensor):
    """Points p (B, K, 3 or 2) in every box's yawed frame: (lx, ly, cos,
    sin), each (B, K, nt)."""
    c, s = torch.cos(terrain.yaw)[:, None], torch.sin(terrain.yaw)[:, None]
    dx = p[..., 0, None] - terrain.pos[:, None, :, 0]
    dy = p[..., 1, None] - terrain.pos[:, None, :, 1]
    return c * dx + s * dy, -s * dx + c * dy, c, s


def support_height(terrain: Terrain | None, xy: torch.Tensor) -> torch.Tensor:
    """Support height under world xy (B, K, 2): the floor (or heightfield
    surface) and the top faces of the boxes whose yawed footprint holds the
    point, whichever is highest (B, K)."""
    if terrain is None:
        return torch.zeros_like(xy[..., 0])
    ground = terrain.floor_z[:, None].expand(xy.shape[:-1])
    if terrain.hfield is not None:
        ground = ground + hfield_query(terrain, xy)[0]
    if terrain.pos.shape[1] == 0:
        return ground
    lx, ly, _, _ = _box_local(terrain, xy)
    size = terrain.size[:, None]
    inside = (torch.abs(lx) <= size[..., 0]) & (torch.abs(ly) <= size[..., 1])
    top = (terrain.pos[..., 2] + terrain.size[..., 2])[:, None]
    tops = torch.where(inside, top, torch.full_like(top, -torch.inf))
    return torch.maximum(ground, torch.max(tops, dim=-1).values)


def terrain_contact(terrain: Terrain, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Point-vs-terrain-box contact for points p (B, K, 3): (signed distance
    (B, K), outward unit normal (B, K, 3)); the floor has slots of its own.

    A point inside a box is pushed out through its nearest face, top or
    side. Among the penetrated boxes the shallowest penetration wins; equal
    ones share the normal. Boxes whose bottom rests at or below the floor
    are columns with no bottom face. No penetrated box: distance 1e3, +z."""
    lx, ly, c, s = _box_local(terrain, p)
    lz = p[..., 2, None] - terrain.pos[:, None, :, 2]
    size = terrain.size[:, None]
    sz_half = size[..., 2]
    ex = torch.abs(lx) - size[..., 0]
    ey = torch.abs(ly) - size[..., 1]
    resting = (terrain.pos[..., 2] - terrain.size[..., 2] <= terrain.floor_z[:, None] + 1e-4)[:, None]
    ez = torch.where(resting, lz - sz_half, torch.abs(lz) - sz_half)
    sgz = torch.where(resting, torch.ones_like(lz), torch.sign(lz))
    inside = (ex < 0.0) & (ey < 0.0) & (ez < 0.0)
    pen = torch.maximum(torch.maximum(ex, ey), ez)
    is_z = (ez >= ex) & (ez >= ey)
    is_x = ex >= ey
    sx, sy = torch.sign(lx), torch.sign(ly)
    zero = torch.zeros_like(lx)
    nx = torch.where(is_z, zero, torch.where(is_x, sx * c, -sy * s))
    ny = torch.where(is_z, zero, torch.where(is_x, sx * s, sy * c))
    nz = torch.where(is_z, sgz, zero)

    any_pen = torch.any(inside, dim=-1)
    score = torch.where(inside, pen, torch.full_like(pen, -1e9))
    best = torch.max(score, dim=-1).values
    sel = ((score == best[..., None]) & inside).to(p.dtype)
    sel = sel / torch.clamp_min(torch.sum(sel, dim=-1, keepdim=True), 1.0)
    n = torch.stack([torch.sum(sel * nx, -1), torch.sum(sel * ny, -1), torch.sum(sel * nz, -1)], dim=-1)
    n = n / torch.clamp_min(torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)), 1e-6)
    z_up = torch.zeros_like(n)
    z_up[..., 2] = 1.0
    normal = torch.where(any_pen[..., None], n, z_up)
    dist = torch.where(any_pen, best, torch.full_like(best, 1e3))
    return dist, normal


def frame_from_normal(n: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit normals -> (..., 3, 3) contact frames, rows (n, t1, t2),
    t1 horizontal. For n = +z this is the static (z, x, y) frame."""
    h2 = n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1]
    h = torch.sqrt(torch.clamp_min(h2, 1e-12))
    horiz = h2 > 0.25
    zero = torch.zeros_like(h)
    t1 = torch.stack(
        [torch.where(horiz, -n[..., 1] / h, zero + 1.0), torch.where(horiz, n[..., 0] / h, zero), zero], dim=-1
    )
    return torch.stack([n, t1, maths.cross(n, t1)], dim=-2)


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
    """Contact slots per foot geom: 4 bottom corners vs the floor plane or
    heightfield, plus (terrain-box models) 4 corners vs the box SDF."""
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
    from .batched import body_velocities_b, fk_b, motion_subspace_b

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
