"""Unitree H1 walking environment (counterpart of learninghumanoidwalking_tpu/envs/h1_walk.py).

35-D robot state (with the motor torques) + 8 external obs (clock, mode
one-hot, mode reference) = 43-D observations, mirror index lists, fixed
obs normalization, gait 0.5 s total / 0.4 swing / 0.1 stance, observation
noise, perturbation wrenches and dynamics randomization on
(envs/configs/h1_walk.json). Provides the imitation projector through
which ``--imitate`` distils an h1_walk expert.
"""

from __future__ import annotations

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.envs.h1_stand import h1_setup
from learninghumanoidwalking_tpu_torch.envs.humanoid import HumanoidEnv
from learninghumanoidwalking_tpu_torch.envs.walking_mixin import WalkingTaskMixin
from learninghumanoidwalking_tpu_torch.rl.imitation import ImitationQuery
from learninghumanoidwalking_tpu_torch.tasks import walking


class H1WalkEnv(WalkingTaskMixin, HumanoidEnv):
    ROOT_BODY = "pelvis"
    HEAD_BODY = "torso_link"
    LFOOT_BODY = "left_ankle_link"
    RFOOT_BODY = "right_ankle_link"
    include_torque_obs = True

    def __init__(self, path_to_json: str | None = None, device: str | torch.device = "cuda"):
        pose = h1_setup(self, "h1_walk.json", path_to_json, device)
        self.reward_names = walking.REWARD_NAMES
        self._finalize()
        self._setup_walking()
        self._setup_mirror()

        # fixed obs normalization (JAX envs/h1_walk.py)
        nu = self.model.nu
        self.obs_mean = np.concatenate(
            [np.zeros(5), pose, np.zeros(nu), np.zeros(nu), [0, 0], [0.5, 0.5, 0.5, 0, 0, 0]]
        )
        self.obs_std = np.concatenate(
            [[0.2, 0.2, 1, 1, 1], 0.5 * np.ones(nu), 4 * np.ones(nu), 100 * np.ones(nu), [1, 1], [1, 1, 1, 0.5, 0.5, 0.5]]
        )
        self.obs_mean = np.tile(self.obs_mean, self.history_len)
        self.obs_std = np.tile(self.obs_std, self.history_len)

    def _setup_mirror(self) -> None:
        """Mirror indices over the 35-D robot state + 8 external obs. Motor
        blocks are left(5) then right(5); within a leg hip_yaw, hip_roll,
        hip_pitch, knee, ankle, and yaw / roll flip sign under the mirror
        (-0.1 stands for index 0 negated)."""
        base = [
            -0.1, 1,
            -2, 3, -4,
            # motor_pos: left block <- right block
            -10, -11, 12, 13, 14,
            -5, -6, 7, 8, 9,
            # motor_vel
            -20, -21, 22, 23, 24,
            -15, -16, 17, 18, 19,
            # motor_tau
            -30, -31, 32, 33, 34,
            -25, -26, 27, 28, 29,
        ]
        ext = [len(base) + i for i in range(self.num_external_obs)]
        self.clock_inds = ext[0:2]
        self.mirrored_obs = base + ext
        self.mirrored_acts = [-5, -6, 7, 8, 9, -0.1, -1, 2, 3, 4]

    def imitation_projector(self):
        """Identity projector: the h1_walk expert and this env share the
        observation space, so expert_obs = obs and every sample counts."""
        action_indices = tuple(range(self.action_size))

        def project(obs_batch: torch.Tensor) -> ImitationQuery:
            return ImitationQuery(
                expert_obs=obs_batch,
                sample_mask=torch.ones(obs_batch.shape[0], device=obs_batch.device),
                action_indices=action_indices,
            )

        return project
