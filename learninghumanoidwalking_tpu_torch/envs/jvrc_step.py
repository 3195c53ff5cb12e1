"""JVRC-1 footstep-following environment: stepping stones, stairs, curves
(counterpart of learninghumanoidwalking_tpu/envs/jvrc_step.py).

29-D robot state + 10 external obs (clock + two lookahead step targets as
root-relative (x, y, z, theta)) -> 39-D observations; 20 terrain boxes under
the planned footsteps (kernel K2 on the card); FORWARD-mode stair-height
curriculum on the training iteration; the jvrc_walk mirror indices with
identity-mirrored goals.
"""

from __future__ import annotations

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.envs.humanoid import HumanoidEnv, load_config
from learninghumanoidwalking_tpu_torch.models import jvrc
from learninghumanoidwalking_tpu_torch.physics import engine, interface
from learninghumanoidwalking_tpu_torch.physics.model import tree_map
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.tasks import rewards, stepping
from learninghumanoidwalking_tpu_torch.utils import maths
from learninghumanoidwalking_tpu_torch.utils.footstep_plans import plan_bank

# force-sensor site offset in the ankle frame
FOOT_SITE_OFFSET = np.array([0.03, 0.0, -0.1], dtype=np.float32)


class JvrcStepEnv(HumanoidEnv):
    ROOT_BODY = "PELVIS_S"
    HEAD_BODY = "NECK_P_S"
    LFOOT_BODY = "L_ANKLE_P_S"
    RFOOT_BODY = "R_ANKLE_P_S"
    include_torque_obs = False
    num_external_obs = 10
    MODE_NAMES = ("CURVED", "STANDING", "BACKWARD", "LATERAL", "FORWARD", "INPLACE")

    def __init__(self, path_to_json: str | None = None, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.cfg = load_config("jvrc_base.json", path_to_json)
        self.spec = jvrc.jvrc_spec(nterrain=stepping.NBOXES)
        self.model = lower(self.spec, device=self.device)

        self.kp = np.asarray(self.cfg.kp, dtype=np.float32)
        self.kd = np.asarray(self.cfg.kd, dtype=np.float32)

        pose = np.deg2rad(np.asarray(self.cfg.half_sitting_pose, dtype=np.float32))
        self.nominal_qpos = np.concatenate(
            [np.array([0, 0, jvrc.NOMINAL_HEIGHT], dtype=np.float32), np.array([1, 0, 0, 0], dtype=np.float32), pose]
        )
        self.reward_names = stepping.REWARD_NAMES
        self._finalize()

        task_cfg = self.cfg.task
        self.goal_height = float(task_cfg.goal_height)
        freq = 1.0 / self.control_dt
        table = rewards.make_phase_clock_tables(
            float(task_cfg.swing_duration), float(task_cfg.stance_duration), 0.1, "grounded", freq
        )
        self.period = int(np.floor(2 * float(task_cfg.total_duration) * freq))
        self.clock_table = torch.as_tensor(np.asarray(table, np.float32), device=self.device)
        self.delay_frames = int(np.floor(float(task_cfg.swing_duration) / self.control_dt))

        plans, plan_lengths = plan_bank()
        self.plans = torch.as_tensor(plans, device=self.device)
        self.plan_lengths = torch.as_tensor(plan_lengths, dtype=torch.int64, device=self.device)

        self._setup_mirror()
        self.obs_mean = np.concatenate([np.zeros(5), pose, np.zeros(12), [0.5, 0.5], np.zeros(8)])
        self.obs_std = np.concatenate([[0.2, 0.2, 1, 1, 1], 0.5 * np.ones(12), 4 * np.ones(12), [1, 1], np.ones(8)])
        self.obs_mean = np.tile(self.obs_mean, self.history_len)
        self.obs_std = np.tile(self.obs_std, self.history_len)

    def _setup_mirror(self) -> None:
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

    # ----------------------------------------------------------------- hooks

    def _foot_site(self, physics, body_idx: int) -> torch.Tensor:
        offset = torch.as_tensor(FOOT_SITE_OFFSET, device=physics.xpos.device)
        return physics.xpos[:, body_idx] + maths.quat_rotate(physics.xquat[:, body_idx], offset)

    def _task_reset(self, draws, n, iteration, physics):
        """Plans from the pre-settle reset pose, as the reference builds them;
        ``iteration`` (None, an int or (n,)) sets the stair height."""
        if iteration is None:
            iteration = 0
        iteration = torch.as_tensor(iteration, dtype=torch.int64, device=self.device).expand(n)
        root_yaw = maths.quat_to_rpy(physics.xquat[:, self.root_idx])[:, 2]
        return stepping.reset(
            draws,
            self.period,
            iteration,
            self.plans,
            self.plan_lengths,
            self._foot_site(physics, self.lfoot_idx),
            self._foot_site(physics, self.rfoot_idx),
            root_yaw,
            physics.xpos[:, self.root_idx],
            physics.xquat[:, self.root_idx],
        )

    def _task_step(self, draws, task, physics):
        """Target tracking on the post-substep physics."""
        return stepping.step(
            task,
            self.period,
            self.delay_frames,
            self._foot_site(physics, self.lfoot_idx),
            self._foot_site(physics, self.rfoot_idx),
            physics.xpos[:, self.root_idx],
            physics.xquat[:, self.root_idx],
        )

    def _reward(self, state, physics, task, target):
        l_grf, r_grf = self._foot_grf(physics)
        return stepping.compute_reward(
            task,
            self.clock_table,
            self.robot_mass,
            self.goal_height,
            l_foot_frc=l_grf,
            r_foot_frc=r_grf,
            l_foot_speed=torch.linalg.vector_norm(physics.body_vel_world(self.lfoot_idx), dim=-1),
            r_foot_speed=torch.linalg.vector_norm(physics.body_vel_world(self.rfoot_idx), dim=-1),
            l_foot_pos=self._foot_site(physics, self.lfoot_idx),
            r_foot_pos=self._foot_site(physics, self.rfoot_idx),
            root_quat=physics.xquat[:, self.root_idx],
            root_pos=physics.xpos[:, self.root_idx],
            head_xy=physics.xpos[:, self.head_idx, :2],
            root_height=physics.xpos[:, self.root_idx, 2],
            contact_point_z=interface.contact_point_z(physics),
        )

    def _external_obs(self, task) -> torch.Tensor:
        return stepping.external_obs(task, self.period)

    def _terrain(self, task):
        return stepping.make_terrain(task.sequence, task.seq_len, task.mode)

    def render_markers(self, states, i: int) -> dict:
        """Env ``i``'s footstep targets, plan, terrain boxes and mode, world
        frame (JAX envs/jvrc_step.py:163), on the host."""
        task = tree_map(lambda x: x[i : i + 1], states.task)
        terrain = self._terrain(task)
        seq = task.sequence[0].cpu().numpy()
        return {
            "mode": self.MODE_NAMES[int(task.mode[0])],
            "targets": seq[np.asarray([int(task.t1[0]), int(task.t2[0])])],  # (2, 4) x, y, z, theta
            "sequence": seq[: int(task.seq_len[0])],
            "terrain_pos": terrain.pos[0].cpu().numpy(),
            "terrain_size": terrain.size[0].cpu().numpy(),
            "terrain_yaw": terrain.yaw[0].cpu().numpy(),
            "floor_z": float(terrain.floor_z[0]),
        }

    def _done(self, physics) -> torch.Tensor:
        selfcol = engine.self_collision(self.model, physics.xpos, physics.xquat)
        min_foot_z = torch.minimum(
            self._foot_site(physics, self.lfoot_idx)[:, 2], self._foot_site(physics, self.rfoot_idx)[:, 2]
        )
        return stepping.done(physics.xpos[:, self.root_idx, 2], min_foot_z, selfcol)
