"""Reward library: batched torch reward terms + precomputed gait-clock tables
(counterpart of learninghumanoidwalking_tpu/tasks/rewards.py; the clock
construction is the same numpy/scipy code, the reward terms take
batch-leading tensors).

Behavioral parity with reference tasks/rewards.py (Osu-DRL/Cassie-style
clock rewards): mostly exp(-k * err^2) shapes, plus tan-saturated phase-clock
scores for foot forces and velocities.

TPU-native design change: the reference builds scipy PchipInterpolator phase
splines at every episode reset (rewards.py:196-300) and evaluates them per
step on the host. Gait parameters are config constants, so here the splines
are evaluated ONCE at env-construction time into dense per-phase lookup
tables (period entries); each step the clock is a table lookup. Values agree
with the reference at every integer phase the reference ever evaluates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# phase clock construction (host-side, numpy/scipy)
# ---------------------------------------------------------------------------


def _cycle_knots(swing: float, stance: float, relaxer: float, stance_mode: str, freq: float):
    """Knot times/values for one gait cycle of the right-foot force clock.

    Cycle structure: right swing, double stance, left swing, double stance
    (total = 2*(swing+stance)). Each segment contributes two knots pulled
    inward by `relaxer` of its span. Force clock value is -1 while that foot
    swings, +1 while it stances; double-stance value depends on stance_mode
    (grounded: +1, aerial: -1, zero: 0). Velocity clock = -force clock
    (swing encourages foot speed, stance penalizes it), except 'zero' mode
    where both are 0.
    """
    seg_bounds = np.array([0.0, swing, swing + stance, 2 * swing + stance, 2 * (swing + stance)]) * freq
    dbl_frc = {"grounded": 1.0, "aerial": -1.0, "zero": 0.0}[stance_mode]
    dbl_vel = {"grounded": -1.0, "aerial": 1.0, "zero": 0.0}[stance_mode]
    # right-foot force value per segment: swing, dbl, left-swing(=stance), dbl
    r_frc_vals = [-1.0, dbl_frc, 1.0, dbl_frc]
    l_frc_vals = [1.0, dbl_frc, -1.0, dbl_frc]

    times, r_frc, r_vel, l_frc, l_vel = [], [], [], [], []
    for k in range(4):
        a, b = seg_bounds[k], seg_bounds[k + 1]
        off = (b - a) * relaxer
        for t in (a + off, b - off):
            times.append(t)
            r_frc.append(r_frc_vals[k])
            l_frc.append(l_frc_vals[k])
            r_vel.append(-r_frc_vals[k] if stance_mode != "zero" or r_frc_vals[k] != 0 else 0.0)
            l_vel.append(-l_frc_vals[k] if stance_mode != "zero" or l_frc_vals[k] != 0 else 0.0)
    last_off = (seg_bounds[4] - seg_bounds[3]) * relaxer
    return np.array(times), np.array(r_frc), np.array(r_vel), np.array(l_frc), np.array(l_vel), last_off


def make_phase_clock_tables(
    swing_duration: float,
    stance_duration: float,
    strict_relaxer: float = 0.1,
    stance_mode: str = "grounded",
    freq: float = 40.0,
) -> np.ndarray:
    """Dense per-phase clock tables, shape (period, 4): [r_frc, r_vel, l_frc, l_vel].

    period = floor(2 * (swing + stance) * freq), the number of control steps
    in one full gait cycle (walking_task.py:199-205). Knots are tripled across
    the previous/current/next cycle before monotone-cubic interpolation so the
    cycle boundary is smooth, mirroring the reference's 3-cycle extension
    (rewards.py:267-298).
    """
    from scipy.interpolate import PchipInterpolator

    times, r_frc, r_vel, l_frc, l_vel, last_off = _cycle_knots(
        swing_duration, stance_duration, strict_relaxer, stance_mode, freq
    )
    cycle_span = times[-1] + last_off
    times3 = np.concatenate([times - cycle_span, times, times + cycle_span])
    period = int(np.floor(2 * (swing_duration + stance_duration) * freq))
    phases = np.arange(period)
    table = np.zeros((period, 4), dtype=np.float32)
    for col, vals in enumerate((r_frc, r_vel, l_frc, l_vel)):
        spline = PchipInterpolator(times3, np.concatenate([vals, vals, vals]))
        table[:, col] = spline(phases)
    return table


def double_support_mask(table: np.ndarray) -> np.ndarray:
    """(period,) bool: phases where both feet are in firm stance
    (both force clocks saturated at +1, walking_task.py:155)."""
    return (table[:, 0] > 1.0 - 1e-5) & (table[:, 2] > 1.0 - 1e-5)


# ---------------------------------------------------------------------------
# reward terms (batch-leading; reference tasks/rewards.py:9-194)
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def vel_reward(vel, goal_vel):
    """exp(-10 ||v - v*||^2) linear velocity tracking."""
    err = _norm(vel - goal_vel)
    return torch.exp(-10.0 * err**2)


def yaw_vel_reward(yaw_vel, yaw_ref):
    """exp(-10 |err|^3) yaw-rate tracking."""
    return torch.exp(-10.0 * torch.abs(yaw_vel - yaw_ref) ** 3)


def action_smoothness_reward(action, prev_action):
    """exp(-5 mean|da|)."""
    return torch.exp(-5.0 * torch.mean(torch.abs(prev_action - action), dim=-1))


def torque_smoothness_reward(torque, prev_torque):
    """exp(-0.25 mean|dtau|)."""
    return torch.exp(-0.25 * torch.mean(torch.abs(prev_torque - torque), dim=-1))


def height_reward(current_height, goal_height, goal_speed, contact_point_z):
    """Speed-scaled deadzone height tracking."""
    err = torch.abs((current_height - contact_point_z) - goal_height)
    deadzone = 0.01 + 0.05 * goal_speed
    err = torch.where(err < deadzone, torch.zeros_like(err), err)
    return torch.exp(-40.0 * torch.square(err))


def root_accel_reward(qvel, qacc):
    """Penalize root angular rate + linear acceleration."""
    err = 0.25 * (torch.sum(torch.abs(qvel[:, 3:6]), dim=-1) + torch.sum(torch.abs(qacc[:, 0:3]), dim=-1))
    return torch.exp(-err)


def _clock_score(clock, raw, max_val):
    normed = torch.clamp_max(raw, max_val) / max_val * 2.0 - 1.0
    return torch.tan(math.pi / 4.0 * clock * normed)


def foot_frc_clock_reward(l_frc, r_frc, l_clock, r_clock, robot_mass):
    """tan-saturated GRF-vs-clock alignment, GRF normalized by mg/2."""
    max_frc = robot_mass * 9.8 * 0.5
    return 0.5 * (_clock_score(l_clock, l_frc, max_frc) + _clock_score(r_clock, r_frc, max_frc))


def foot_vel_clock_reward(l_vel_norm, r_vel_norm, l_clock, r_clock):
    """Foot-speed-vs-clock alignment, speeds normalized by 0.2 m/s."""
    return 0.5 * (_clock_score(l_clock, l_vel_norm, 0.2) + _clock_score(r_clock, r_vel_norm, 0.2))


def upper_body_reward(head_xy, root_xy):
    """exp(-10 ||head - root||_xy)."""
    return torch.exp(-10.0 * _norm(head_xy - root_xy))


def posture_reward(pose, neutral_pose):
    """exp(-||pose - neutral||)."""
    return torch.exp(-_norm(neutral_pose - pose))


def body_orient_reward(body_quat, target_quat):
    """exp(-10 (1 - <q, q*>^2)) orientation tracking."""
    return torch.exp(-10.0 * (1.0 - torch.sum(target_quat * body_quat, dim=-1) ** 2))
