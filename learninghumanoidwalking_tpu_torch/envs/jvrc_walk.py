"""JVRC-1 walking environment (counterpart of learninghumanoidwalking_tpu/envs/jvrc_walk.py).

29-D robot state (roll, pitch, root angular velocity, 12 motor positions and
velocities) + 8 external obs (clock, mode one-hot, mode reference) = 37-D
observations; mirror index lists for symmetry learning; fixed obs
normalization.
"""

from __future__ import annotations

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.envs.humanoid import HumanoidEnv, load_config
from learninghumanoidwalking_tpu_torch.envs.walking_mixin import WalkingTaskMixin
from learninghumanoidwalking_tpu_torch.models import jvrc
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.tasks import walking


class JvrcWalkEnv(WalkingTaskMixin, HumanoidEnv):
    ROOT_BODY = "PELVIS_S"
    HEAD_BODY = "NECK_P_S"
    LFOOT_BODY = "L_ANKLE_P_S"
    RFOOT_BODY = "R_ANKLE_P_S"
    include_torque_obs = False

    def __init__(self, path_to_json: str | None = None, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.cfg = load_config("jvrc_base.json", path_to_json)
        self.spec = jvrc.jvrc_spec()
        self.model = lower(self.spec, device=self.device)

        self.kp = np.asarray(self.cfg.kp, dtype=np.float32)
        self.kd = np.asarray(self.cfg.kd, dtype=np.float32)

        pose = np.deg2rad(np.asarray(self.cfg.half_sitting_pose, dtype=np.float32))
        self.nominal_qpos = np.concatenate(
            [np.array([0, 0, jvrc.NOMINAL_HEIGHT], dtype=np.float32), np.array([1, 0, 0, 0], dtype=np.float32), pose]
        )
        self.reward_names = walking.REWARD_NAMES
        self._finalize()
        self._setup_walking()
        self._setup_mirror()

        # fixed obs normalization (reference jvrc_walk.py:45-63)
        self.obs_mean = np.concatenate([np.zeros(5), pose, np.zeros(12), [0, 0, 0.5, 0.5, 0.5, 0, 0, 0]])
        self.obs_std = np.concatenate(
            [[0.2, 0.2, 1, 1, 1], 0.5 * np.ones(12), 4 * np.ones(12), [1, 1, 1, 1, 1, 0.5, 0.5, 0.5]]
        )
        self.obs_mean = np.tile(self.obs_mean, self.history_len)
        self.obs_std = np.tile(self.obs_std, self.history_len)

    def _setup_mirror(self) -> None:
        """Mirror index lists over the 29-D robot state + 8 external obs:
        swap the R/L motor blocks and negate roll/yaw quantities."""
        base = [
            -0.1, 1,
            -2, 3, -4,
            11, -12, -13, 14, -15, 16,
            5, -6, -7, 8, -9, 10,
            23, -24, -25, 26, -27, 28,
            17, -18, -19, 20, -21, 22,
        ]
        ext = [len(base) + i for i in range(self.num_external_obs)]
        self.clock_inds = ext[0:2]
        self.mirrored_obs = base + ext
        self.mirrored_acts = [6, -7, -8, 9, -10, 11, 0.1, -1, -2, 3, -4, 5]
