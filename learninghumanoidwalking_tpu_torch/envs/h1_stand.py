"""Unitree H1 standing environment (counterpart of learninghumanoidwalking_tpu/envs/h1_stand.py).

35-D observations: roll, pitch, root angular velocity, and the 10 motors'
positions, velocities and torques (the last substep's applied torque); no
external observations; fixed obs normalization; observation noise,
perturbation wrenches and dynamics randomization on (envs/configs/h1_base.json).
"""

from __future__ import annotations

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.envs.humanoid import HumanoidEnv, load_config
from learninghumanoidwalking_tpu_torch.models import h1
from learninghumanoidwalking_tpu_torch.physics import engine
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.tasks import standing
from learninghumanoidwalking_tpu_torch.utils import maths


def h1_setup(env, config_name: str, path_to_json: str | None, device) -> np.ndarray:
    """The H1 envs' shared set-up up to _finalize: device, config, model, PD
    gains by joint name, nominal qpos. Returns the half-sitting pose."""
    env.device = torch.device(device)
    env.cfg = load_config(config_name, path_to_json)
    env.spec = h1.h1_spec()
    env.model = lower(env.spec, device=env.device)
    gains = env.cfg.pdgains.to_dict()
    kp, kd = zip(*[gains[j] for j in h1.LEG_JOINTS])
    env.kp = np.asarray(kp, dtype=np.float32)
    env.kd = np.asarray(kd, dtype=np.float32)
    pose = np.asarray(env.cfg.half_sitting_pose, dtype=np.float32)
    env.nominal_qpos = np.concatenate(
        [np.array([0, 0, h1.NOMINAL_HEIGHT], dtype=np.float32), np.array([1, 0, 0, 0], dtype=np.float32), pose]
    )
    return pose


class H1StandEnv(HumanoidEnv):
    ROOT_BODY = "pelvis"
    HEAD_BODY = "torso_link"
    LFOOT_BODY = "left_ankle_link"
    RFOOT_BODY = "right_ankle_link"
    include_torque_obs = True
    num_external_obs = 0

    def __init__(self, path_to_json: str | None = None, device: str | torch.device = "cuda"):
        pose = h1_setup(self, "h1_base.json", path_to_json, device)
        self.reward_names = standing.REWARD_NAMES
        self._finalize()

        # fixed obs normalization (JAX envs/h1_stand.py)
        nu = self.model.nu
        self.obs_mean = np.concatenate([np.zeros(5), pose, np.zeros(2 * nu)])
        self.obs_std = np.concatenate([[0.2, 0.2, 1, 1, 1], 0.5 * np.ones(nu), 4 * np.ones(nu), 100 * np.ones(nu)])
        self.obs_mean = np.tile(self.obs_mean, self.history_len)
        self.obs_std = np.tile(self.obs_std, self.history_len)

    def _reward(self, state, physics, task, target) -> torch.Tensor:
        root_q = physics.xquat[:, self.root_idx]
        head_off = maths.quat_rotate_inv(root_q, physics.xpos[:, self.head_idx] - physics.xpos[:, self.root_idx])[:, :2]
        return standing.compute_reward(
            neutral_pose=self.neutral_pose,
            root_vel_local_xy=self._root_local_vel_xy(physics),
            yaw_vel=physics.qvel[:, 5],
            root_height=physics.xpos[:, self.root_idx, 2],
            head_offset_in_base_xy=head_off,
            pose=self._motor_pos(physics),
            torque=physics.act_torque,
        )

    def _done(self, physics) -> torch.Tensor:
        selfcol = engine.self_collision(self.model, physics.xpos, physics.xquat)
        return standing.done(physics.qpos[:, 2], selfcol)
