"""Standing balance task for H1 (counterpart of learninghumanoidwalking_tpu/tasks/standing.py).

Stateless: the reward terms and the termination are functions of the
physics state, written over the batch. Weights and thresholds are the JAX
package's.
"""

from __future__ import annotations

import torch

REWARD_NAMES = (
    "com_vel_error",
    "yaw_vel_error",
    "height",
    "upperbody",
    "joint_torque_reward",
    "posture",
)

TARGET_ROOT_H = 0.98


def compute_reward(
    neutral_pose: torch.Tensor,
    root_vel_local_xy: torch.Tensor,  # (B, 2)
    yaw_vel: torch.Tensor,  # (B,)
    root_height: torch.Tensor,  # (B,)
    head_offset_in_base_xy: torch.Tensor,  # (B, 2) head position in the root frame
    pose: torch.Tensor,  # (B, nu)
    torque: torch.Tensor,  # (B, nu)
) -> torch.Tensor:
    """(B, 6) weighted reward terms, in REWARD_NAMES order."""
    fwd_vel_err = torch.linalg.vector_norm(root_vel_local_xy, dim=-1)
    height_err = torch.abs(root_height - TARGET_ROOT_H)
    upper_err = torch.linalg.vector_norm(head_offset_in_base_xy, dim=-1)
    posture_err = torch.linalg.vector_norm(pose - neutral_pose, dim=-1)
    tau_err = torch.linalg.vector_norm(torque, dim=-1)
    return torch.stack(
        [
            0.3 * torch.exp(-4.0 * torch.square(fwd_vel_err)),
            0.3 * torch.exp(-4.0 * torch.square(yaw_vel)),
            0.1 * torch.exp(-0.5 * torch.square(height_err)),
            0.1 * torch.exp(-40.0 * torch.square(upper_err)),
            0.1 * torch.exp(-5e-5 * torch.square(tau_err)),
            0.1 * torch.exp(-1.0 * torch.square(posture_err)),
        ],
        dim=-1,
    )


def done(root_height: torch.Tensor, self_collision: torch.Tensor) -> torch.Tensor:
    """Terminate outside z in (0.9, 1.4) or on self-collision."""
    return (root_height < 0.9) | (root_height > 1.4) | self_collision
