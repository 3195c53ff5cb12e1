"""Mode-conditioned walking task (STANDING / INPLACE / FORWARD), batch-leading
(counterpart of learninghumanoidwalking_tpu/tasks/walking.py).

Mode codes FORWARD=0, INPLACE=1, STANDING=2; reward weights and termination
thresholds are the JAX package's. Random draws come from a ``Draws`` source
by name (utils/seeding.py), so tests can inject the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.tasks import rewards

FORWARD, INPLACE, STANDING = 0, 1, 2

REWARD_NAMES = (
    "foot_frc_score",
    "foot_vel_score",
    "root_accel",
    "height_error",
    "com_vel_error",
    "yaw_vel_error",
    "upper_body_reward",
    "posture_error",
    "torque_penalty",
    "action_penalty",
)

WEIGHTS = np.array([0.225, 0.225, 0.050, 0.050, 0.150, 0.150, 0.050, 0.050, 0.025, 0.025], dtype=np.float32)


@dataclasses.dataclass
class WalkingState:
    mode: torch.Tensor  # (B,) int64
    mode_ref: torch.Tensor  # (B, 3) [yaw_vel, vx, vy]
    phase: torch.Tensor  # (B,) int64


def sample_mode_ref(draws, mode: torch.Tensor) -> torch.Tensor:
    """Velocity reference per mode."""
    n, dev = mode.shape[0], mode.device
    standing_ref = draws.uniform("task.standing_ref", (n, 3), -1.0, 1.0, dev)
    zeros = torch.zeros((n,), device=dev)
    inplace_ref = torch.stack([draws.uniform("task.inplace_yaw", (n,), -0.5, 0.5, dev), zeros, zeros], dim=-1)
    forward_ref = torch.stack([zeros, draws.uniform("task.forward_vx", (n,), 0.0, 0.4, dev), zeros], dim=-1)
    m = mode[:, None]
    return torch.where(m == STANDING, standing_ref, torch.where(m == INPLACE, inplace_ref, forward_ref))


def reset(draws, num_envs: int, period: int, device) -> WalkingState:
    """mode ~ p=[STANDING .6, INPLACE .2, FORWARD .2] and a random phase."""
    mode = draws.choice("task.mode", (num_envs,), [STANDING, INPLACE, FORWARD], [0.6, 0.2, 0.2], device)
    return WalkingState(
        mode=mode.to(torch.int64),
        mode_ref=sample_mode_ref(draws, mode),
        phase=draws.randint("task.phase", (num_envs,), 0, period, device),
    )


def step(draws, ts: WalkingState, period: int, dbl_support: torch.Tensor) -> WalkingState:
    """Phase increment + random mode switches."""
    n, dev = ts.mode.shape[0], ts.mode.device
    phase = torch.remainder(ts.phase + 1, period)

    # INPLACE <-> STANDING, only in double support, p = 1/100
    in_dbl = dbl_support[phase] > 0
    ev1 = (draws.randint("task.switch1", (n,), 0, 100, dev) == 0) & in_dbl
    mode = ts.mode
    toggled1 = torch.where(mode == INPLACE, STANDING, torch.where(mode == STANDING, INPLACE, mode))
    switch1 = ev1 & ((mode == INPLACE) | (mode == STANDING))
    mode = torch.where(switch1, toggled1, mode)

    # FORWARD <-> INPLACE, p = 1/200, not while standing
    ev2 = (draws.randint("task.switch2", (n,), 0, 200, dev) == 0) & (mode != STANDING)
    toggled2 = torch.where(mode == FORWARD, INPLACE, torch.where(mode == INPLACE, FORWARD, mode))
    switch2 = ev2 & ((mode == FORWARD) | (mode == INPLACE))
    mode = torch.where(switch2, toggled2, mode)

    switched = switch1 | switch2
    mode_ref = torch.where(switched[:, None], sample_mode_ref(draws, mode), ts.mode_ref)
    return WalkingState(mode=mode, mode_ref=mode_ref, phase=phase)


def external_obs(ts: WalkingState, period: int) -> torch.Tensor:
    """clock(2) + mode one-hot(3) + mode_ref(3)."""
    angle = 2.0 * math.pi * ts.phase.to(torch.float32) / period
    clock = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    one_hot = torch.nn.functional.one_hot(ts.mode, 3).to(torch.float32)
    return torch.cat([clock, one_hot, ts.mode_ref], dim=-1)


def compute_reward(
    ts: WalkingState,
    clock_table: torch.Tensor,  # (period, 4): r_frc, r_vel, l_frc, l_vel
    robot_mass: float,
    goal_height: float,
    neutral_pose: torch.Tensor,
    l_foot_frc,
    r_foot_frc,
    l_foot_speed,
    r_foot_speed,
    head_xy,
    root_xy,
    root_height,
    contact_point_z,
    root_vel_local_xy,
    yaw_vel,
    qvel,
    qacc,
    torque,
    prev_torque,
    pose,
    action,
    prev_action,
) -> torch.Tensor:
    """(B, 10) weighted reward components."""
    clocks = clock_table[ts.phase]
    standing = ts.mode == STANDING
    one = torch.ones_like(clocks[:, 0])
    r_frc = torch.where(standing, one, clocks[:, 0])
    r_vel = torch.where(standing, -one, clocks[:, 1])
    l_frc = torch.where(standing, one, clocks[:, 2])
    l_vel = torch.where(standing, -one, clocks[:, 3])

    zero = torch.zeros_like(one)
    forward = ts.mode == FORWARD
    yaw_ref = torch.where(standing | forward, zero, ts.mode_ref[:, 0])
    vx_ref = torch.where(forward, ts.mode_ref[:, 1], zero)
    vy_ref = torch.where(forward, ts.mode_ref[:, 2], zero)
    goal_vel_xy = torch.stack([vx_ref, vy_ref], dim=-1)
    goal_speed = torch.sqrt(torch.sum(goal_vel_xy * goal_vel_xy, dim=-1))

    components = torch.stack(
        [
            rewards.foot_frc_clock_reward(l_foot_frc, r_foot_frc, l_frc, r_frc, robot_mass),
            rewards.foot_vel_clock_reward(l_foot_speed, r_foot_speed, l_vel, r_vel),
            rewards.root_accel_reward(qvel, qacc),
            rewards.height_reward(root_height, goal_height, goal_speed, contact_point_z),
            rewards.vel_reward(root_vel_local_xy, goal_vel_xy),
            rewards.yaw_vel_reward(yaw_vel, yaw_ref),
            rewards.upper_body_reward(head_xy, root_xy),
            rewards.posture_reward(pose, neutral_pose),
            rewards.torque_smoothness_reward(torque, prev_torque),
            rewards.action_smoothness_reward(action, prev_action),
        ],
        dim=-1,
    )
    return torch.as_tensor(WEIGHTS, device=components.device) * components


def done(root_height, self_collision, z_min=0.6, z_max=1.4):
    """Termination on root height or self-collision."""
    return (root_height < z_min) | (root_height > z_max) | self_collision
