"""Walking-task plumbing for the walking envs (counterpart of
learninghumanoidwalking_tpu/envs/walking_mixin.py): clock tables from the
config's gait durations, task hooks, external observations, reward inputs
and termination."""

from __future__ import annotations

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.physics import engine, interface
from learninghumanoidwalking_tpu_torch.tasks import rewards, walking


class WalkingTaskMixin:
    """Requires HumanoidEnv attributes; call _setup_walking() after _finalize()."""

    num_external_obs = 8  # clock(2) + mode one-hot(3) + mode_ref(3)
    MODE_NAMES = ("FORWARD", "INPLACE", "STANDING")

    def _setup_walking(self) -> None:
        task_cfg = self.cfg.task
        self.goal_height = float(task_cfg.goal_height)
        freq = 1.0 / self.control_dt
        table = rewards.make_phase_clock_tables(
            float(task_cfg.swing_duration),
            float(task_cfg.stance_duration),
            strict_relaxer=0.1,
            stance_mode="grounded",
            freq=freq,
        )
        self.period = int(np.floor(2 * float(task_cfg.total_duration) * freq))
        if self.period != table.shape[0]:
            table = np.resize(table, (self.period, 4))
        self.clock_table = torch.as_tensor(np.asarray(table, np.float32), device=self.device)
        self.dbl_support = torch.as_tensor(
            np.asarray(rewards.double_support_mask(table), np.float32), device=self.device
        )

    def _task_reset(self, draws, n, iteration, physics):
        return walking.reset(draws, n, self.period, self.device)

    def _task_step(self, draws, task, physics):
        return walking.step(draws, task, self.period, self.dbl_support)

    def _external_obs(self, task) -> torch.Tensor:
        return walking.external_obs(task, self.period)

    def _reward(self, state, physics, task, target) -> torch.Tensor:
        l_grf, r_grf = self._foot_grf(physics)
        l_speed = torch.linalg.vector_norm(physics.body_vel_world(self.lfoot_idx), dim=-1)
        r_speed = torch.linalg.vector_norm(physics.body_vel_world(self.rfoot_idx), dim=-1)
        return walking.compute_reward(
            task,
            self.clock_table,
            self.robot_mass,
            self.goal_height,
            self.neutral_pose,
            l_foot_frc=l_grf,
            r_foot_frc=r_grf,
            l_foot_speed=l_speed,
            r_foot_speed=r_speed,
            head_xy=physics.xpos[:, self.head_idx, :2],
            root_xy=physics.xpos[:, self.root_idx, :2],
            root_height=physics.xpos[:, self.root_idx, 2],
            contact_point_z=interface.contact_point_z(physics),
            root_vel_local_xy=self._root_local_vel_xy(physics),
            yaw_vel=physics.qvel[:, 5],
            qvel=physics.qvel,
            qacc=physics.qacc,
            torque=physics.act_torque,
            prev_torque=state.prev_torque,
            pose=self._motor_pos(physics),
            action=target,
            prev_action=state.prev_action,
        )

    def _done(self, physics) -> torch.Tensor:
        selfcol = engine.self_collision(self.model, physics.xpos, physics.xquat)
        return walking.done(physics.qpos[:, 2], selfcol)
