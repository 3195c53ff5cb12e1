"""Footstep-target stepping task, batch-leading (counterpart of
learninghumanoidwalking_tpu/tasks/stepping.py).

Footstep sequences are fixed-shape padded arrays in the task state, the
terrain boxes under them a per-env Terrain, and the mode machine, target
tracking and stair-height curriculum functions of the state. Every random
draw comes from a ``Draws`` source by name (utils/seeding.py): where the JAX
task draws from one key in several branches, each branch here has a draw of
its own, so tests can inject the JAX package's numbers.

Modes (reset p = [CURVED .15, STANDING .05, BACKWARD .2, LATERAL .3,
FORWARD .3]); FORWARD uses the step-height curriculum
clip((iteration - 3000) / 8000, 0, 1) * 0.1 on the training iteration.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.physics.engine import Terrain
from learninghumanoidwalking_tpu_torch.tasks import rewards
from learninghumanoidwalking_tpu_torch.utils import maths
from learninghumanoidwalking_tpu_torch.utils.footstep_plans import MAX_STEPS

CURVED, STANDING, BACKWARD, LATERAL, FORWARD, INPLACE = 0, 1, 2, 3, 4, 5

REWARD_NAMES = (
    "foot_frc_score",
    "foot_vel_score",
    "orient_cost",
    "height_error",
    "step_reward",
    "upper_body_reward",
)

WEIGHTS = np.array([0.150, 0.150, 0.050, 0.050, 0.450, 0.050], dtype=np.float32)

TARGET_RADIUS = 0.20
NBOXES = 20


@dataclasses.dataclass
class SteppingState:
    mode: torch.Tensor  # (B,) int64
    phase: torch.Tensor  # (B,) int64
    sequence: torch.Tensor  # (B, MAX_STEPS, 4) world-frame [x, y, z, theta]
    seq_len: torch.Tensor  # (B,) int64
    t1: torch.Tensor  # (B,) int64 current target index
    t2: torch.Tensor  # (B,) int64 next target index
    target_reached: torch.Tensor  # (B,) bool
    target_reached_frames: torch.Tensor  # (B,) int64
    goal_steps: torch.Tensor  # (B, 2, 4) root-relative [x, y, z, theta] of t1, t2


def _row(sequence: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """sequence[b, idx[b]] -> (B, 4)."""
    return sequence[torch.arange(sequence.shape[0], device=sequence.device), idx]


# ----------------------------------------------------------- sequence makers


def _straight_sequence(first_y_draw, c, phase, period, step_size, step_gap, step_height):
    """Alternating-gap straight sequences (n, MAX_STEPS, 4); logical length 20.
    first_y_draw (n,) ~ U(0.095, 0.105), c (n,) in {2, 3}; step_size and
    step_height scalars or (n,)."""
    n, dev = phase.shape[0], phase.device
    num = 20
    # a Python step size gives the final x in double precision, as in the JAX task
    final_x = torch.as_tensor((num - 1) * step_size, dtype=torch.float32, device=dev).expand(n)
    as_col = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).expand(n)[:, None]
    step_size, step_height = as_col(step_size), as_col(step_height)
    first_sign = torch.where(phase == period // 2, -1.0, 1.0)
    first_y = first_sign * first_y_draw
    y0 = first_sign * step_gap
    i = torch.arange(MAX_STEPS, device=dev)[None]
    x = i * step_size
    y = y0[:, None] * torch.where(i % 2 == 1, -1.0, 1.0)
    z = torch.clamp_min(i - c[:, None], 0) * step_height
    seq = torch.stack([x, y, z, torch.zeros_like(x)], dim=-1)
    seq[:, 0] = 0.0
    seq[:, 0, 1] = first_y
    # the final step mirrors the y of the one before it
    seq[:, num - 1, 0] = final_x
    seq[:, num - 1, 1] = -seq[:, num - 2, 1]
    seq[:, num - 1, 2] = seq[:, num - 2, 2]
    seq[:, num - 1, 3] = 0.0
    seq[:, num:] = seq[:, num - 1 : num]
    return seq, torch.full((n,), num, dtype=torch.int64, device=dev)


def _standing_sequence(first_y_draw, c, phase, period):
    """First step + final step only."""
    seq, _ = _straight_sequence(first_y_draw, c, phase, period, 0.3, 0.15, 0.0)
    first = seq[:, 0].clone()
    out = torch.zeros_like(seq)
    out[..., 0] = 0.3
    out[..., 1] = -first[:, None, 1]
    out[:, 0] = first
    return out, torch.full_like(phase, 2)


def _lateral_sequence(side, n, dev):
    """Side-stepping: y += 0.4 on odd steps, y -= 2/3 * 0.4 on even; side
    (n,) bool picks +y."""
    c = torch.where(side, 1.0, -1.0)
    i = torch.arange(MAX_STEPS, device=dev) + 1
    n_plus = (i + 1) // 2
    n_minus = i // 2
    y = 0.4 * n_plus - (2.0 / 3.0) * 0.4 * n_minus
    zeros = torch.zeros((n, MAX_STEPS), device=dev)
    seq = torch.stack([zeros, c[:, None] * y[None], zeros, zeros], dim=-1)
    num = 19
    seq[:, num:] = seq[:, num - 1 : num]
    return seq, torch.full((n,), num, dtype=torch.int64, device=dev)


def make_sequence(draws, mode, phase, period, iteration, plans, plan_lengths):
    """Mode-dispatched raw sequences in the robot's local frame, (n,
    MAX_STEPS, 4) and lengths (n,). iteration (n,) sets the FORWARD stair
    height."""
    n, dev = mode.shape[0], mode.device
    h = torch.clamp((iteration.to(torch.float32) - 3000.0) / 8000.0, 0.0, 1.0) * 0.1
    h = torch.where(draws.randint("step.height_sign", (n,), 0, 2, dev) == 1, h, -h)
    inplace_size = draws.uniform("step.inplace_size", (n,), -0.05, 0.05, dev)
    first_y = draws.uniform("step.first_y", (n,), 0.095, 0.105, dev)
    c = draws.randint("step.c", (n,), 2, 4, dev)
    plan = draws.randint("step.plan", (n,), 0, plans.shape[0], dev)
    side = draws.randint("step.lateral_side", (n,), 0, 2, dev) == 1

    branches = {
        CURVED: (plans[plan], plan_lengths[plan]),
        STANDING: _standing_sequence(first_y, c, phase, period),
        BACKWARD: _straight_sequence(first_y, c, phase, period, -0.1, 0.15, 0.0),
        LATERAL: _lateral_sequence(side, n, dev),
        FORWARD: _straight_sequence(first_y, c, phase, period, 0.3, 0.15, h),
        INPLACE: _straight_sequence(first_y, c, phase, period, inplace_size, 0.15, 0.0),
    }
    seq = torch.zeros((n, MAX_STEPS, 4), device=dev)
    length = torch.zeros((n,), dtype=torch.int64, device=dev)
    for m, (s, ln) in branches.items():
        sel = mode == m
        seq = torch.where(sel[:, None, None], s, seq)
        length = torch.where(sel, ln.to(torch.int64), length)
    return seq, length


def transform_sequence(seq, lfoot_pos, rfoot_pos, root_yaw):
    """Local-frame plans (n, S, 4) in world coordinates anchored at the feet
    midpoint and the current root yaw."""
    mid = (lfoot_pos + rfoot_pos) / 2.0
    c, s = torch.cos(root_yaw)[:, None], torch.sin(root_yaw)[:, None]
    x = mid[:, None, 0] + seq[..., 0] * c - seq[..., 1] * s
    y = mid[:, None, 1] + seq[..., 0] * s + seq[..., 1] * c
    return torch.stack([x, y, seq[..., 2], seq[..., 3] + root_yaw[:, None]], dim=-1)


def make_terrain(sequence, seq_len, mode, box_half_height=0.1) -> Terrain:
    """Boxes under the steps, half-size (0.15, 1, 0.1), top at the step's z;
    boxes past the plan sit below the floor; the floor drops 2 m in FORWARD
    mode."""
    n, dev = sequence.shape[0], sequence.device
    live = torch.arange(NBOXES, device=dev)[None] < seq_len[:, None]
    steps = sequence[:, :NBOXES]
    zero = torch.zeros_like(steps[..., 0])
    pos = torch.stack(
        [
            torch.where(live, steps[..., 0], zero),
            torch.where(live, steps[..., 1], zero),
            torch.where(live, steps[..., 2] - box_half_height, torch.full_like(zero, -1.0 - box_half_height)),
        ],
        dim=-1,
    )
    size = torch.tensor([0.15, 1.0, box_half_height], device=dev).expand(n, NBOXES, 3)
    yaw = torch.where(live, steps[..., 3], zero)
    floor_z = torch.where(mode == FORWARD, -2.0, 0.0)
    return Terrain(pos=pos, size=size, yaw=yaw, floor_z=floor_z)


# ------------------------------------------------------------------ dynamics


def update_goal_steps(ts: SteppingState, root_pos, root_quat) -> SteppingState:
    """Root-relative poses of the two lookahead targets; zeros in STANDING."""

    def rel(t):
        target = _row(ts.sequence, t)
        d = maths.quat_rotate_inv(root_quat, target[:, :3] - root_pos)
        half = target[:, 3] / 2
        zero = torch.zeros_like(half)
        qz = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)
        rel_q = maths.quat_mul(maths.quat_conj(root_quat), qz)
        return torch.cat([d, maths.quat_to_rpy(rel_q)[:, 2:3]], dim=-1)

    goals = torch.stack([rel(ts.t1), rel(ts.t2)], dim=1)
    goals = torch.where((ts.mode == STANDING)[:, None, None], torch.zeros_like(goals), goals)
    return dataclasses.replace(ts, goal_steps=goals)


def step(ts: SteppingState, period: int, delay_frames: int, l_foot_pos, r_foot_pos, root_pos, root_quat):
    """Phase advance + target-reach tracking."""
    phase = torch.remainder(ts.phase + 1, period)
    target = _row(ts.sequence, ts.t1)[:, :3]
    dist = torch.minimum(
        torch.linalg.vector_norm(l_foot_pos - target, dim=-1), torch.linalg.vector_norm(r_foot_pos - target, dim=-1)
    )
    in_target = dist < TARGET_RADIUS
    frames = torch.where(in_target, ts.target_reached_frames + 1, torch.zeros_like(ts.target_reached_frames))
    advance = in_target & (frames >= delay_frames)
    ts = dataclasses.replace(
        ts,
        phase=phase,
        t1=torch.where(advance, ts.t2, ts.t1),
        t2=torch.where(advance, torch.minimum(ts.t2 + 1, ts.seq_len - 1), ts.t2),
        target_reached=in_target & ~advance,
        target_reached_frames=torch.where(advance, torch.zeros_like(frames), frames),
    )
    return update_goal_steps(ts, root_pos, root_quat)


def step_reward(ts: SteppingState, l_foot_pos, r_foot_pos, root_xy) -> torch.Tensor:
    """0.8 * hit + 0.2 * progress."""
    t1 = _row(ts.sequence, ts.t1)
    foot_dist = torch.minimum(
        torch.linalg.vector_norm(l_foot_pos - t1[:, :3], dim=-1), torch.linalg.vector_norm(r_foot_pos - t1[:, :3], dim=-1)
    )
    hit = torch.where(ts.target_reached, torch.exp(-foot_dist / 0.25), torch.zeros_like(foot_dist))
    mid = (t1[:, :2] + _row(ts.sequence, ts.t2)[:, :2]) / 2.0
    progress = torch.exp(-torch.linalg.vector_norm(root_xy - mid, dim=-1) / 2.0)
    return 0.8 * hit + 0.2 * progress


def compute_reward(
    ts: SteppingState,
    clock_table: torch.Tensor,
    robot_mass: float,
    goal_height: float,
    l_foot_frc,
    r_foot_frc,
    l_foot_speed,
    r_foot_speed,
    l_foot_pos,
    r_foot_pos,
    root_quat,
    root_pos,
    head_xy,
    root_height,
    contact_point_z,
) -> torch.Tensor:
    """(B, 6) weighted reward components."""
    clocks = clock_table[ts.phase]
    standing = ts.mode == STANDING
    one = torch.ones_like(clocks[:, 0])
    r_frc = torch.where(standing, one, clocks[:, 0])
    r_vel = torch.where(standing, -one, clocks[:, 1])
    l_frc = torch.where(standing, one, clocks[:, 2])
    l_vel = torch.where(standing, -one, clocks[:, 3])

    half = _row(ts.sequence, ts.t1)[:, 3] / 2
    zero = torch.zeros_like(half)
    target_quat = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)

    components = torch.stack(
        [
            rewards.foot_frc_clock_reward(l_foot_frc, r_foot_frc, l_frc, r_frc, robot_mass),
            rewards.foot_vel_clock_reward(l_foot_speed, r_foot_speed, l_vel, r_vel),
            rewards.body_orient_reward(root_quat, target_quat),
            rewards.height_reward(root_height, goal_height, 0.0, contact_point_z),
            step_reward(ts, l_foot_pos, r_foot_pos, root_pos[:, :2]),
            # squared-norm variant of the upper-body term
            torch.exp(-10.0 * torch.sum(torch.square(head_xy - root_pos[:, :2]), dim=-1)),
        ],
        dim=-1,
    )
    return torch.as_tensor(WEIGHTS, device=components.device) * components


def done(root_height, min_foot_z, self_collision) -> torch.Tensor:
    """Root height relative to the lower foot, so stairs do not end an
    episode; or self-collision."""
    return ((root_height - min_foot_z) < 0.6) | self_collision


def reset(draws, period: int, iteration, plans, plan_lengths, lfoot_pos, rfoot_pos, root_yaw, root_pos, root_quat):
    """Mode sample, sequence generation and initial targets for a batch;
    iteration (B,) int sets the stair height."""
    n, dev = root_yaw.shape[0], root_yaw.device
    mode = draws.choice("step.mode", (n,), [CURVED, STANDING, BACKWARD, LATERAL, FORWARD], [0.15, 0.05, 0.2, 0.3, 0.3], dev)
    mode = mode.to(torch.int64)
    phase = torch.where(draws.randint("step.phase_flip", (n,), 0, 2, dev) == 1, 0, period // 2).to(torch.int64)
    seq, seq_len = make_sequence(draws, mode, phase, period, iteration, plans, plan_lengths)
    seq = transform_sequence(seq, lfoot_pos, rfoot_pos, root_yaw)
    zeros = torch.zeros((n,), dtype=torch.int64, device=dev)
    ts = SteppingState(
        mode=mode,
        phase=phase,
        sequence=seq,
        seq_len=seq_len,
        t1=zeros,
        t2=torch.minimum(zeros + 1, seq_len - 1),
        target_reached=torch.zeros((n,), dtype=torch.bool, device=dev),
        target_reached_frames=zeros,
        goal_steps=torch.zeros((n, 2, 4), device=dev),
    )
    return update_goal_steps(ts, root_pos, root_quat)


def external_obs(ts: SteppingState, period: int) -> torch.Tensor:
    """clock(2) + goal x(2) + y(2) + z(2) + theta(2)."""
    angle = 2.0 * math.pi * ts.phase.to(torch.float32) / period
    clock = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    return torch.cat([clock, ts.goal_steps.transpose(1, 2).reshape(-1, 8)], dim=-1)
