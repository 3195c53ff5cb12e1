"""Walking env built from an MJCF robot description file (counterpart of
learninghumanoidwalking_tpu/envs/mjcf_env.py).

Any MJCF file within the importer's subset (physics/mjcf_import.py) becomes
a walking environment:

    make_env("mjcf:/path/to/robot.xml", path_to_json="robot.json")

The JSON supplies what MJCF does not express: which geoms are feet, which
bodies are the root, head and feet, PD gains, the nominal pose and the gait
task's parameters (schema and defaults: configs/mjcf_base.json, over which
the robot file is deep-merged). The imported model runs the same physics as
the built-in robots: on the card through kernel K1 (the flat floor), whose
caps bound which files run there (ops/substep_kernel.py::check_model raises
its message for a larger model; nothing falls back). Observation
normalization takes the running Welford path (``obs_mean`` None: PPO's
warmup iterations run first); the mirror loss is enabled only where the
robot file gives both mirror index lists.
"""

from __future__ import annotations

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.envs.humanoid import HumanoidEnv, load_config
from learninghumanoidwalking_tpu_torch.envs.walking_mixin import WalkingTaskMixin
from learninghumanoidwalking_tpu_torch.physics.mjcf_import import import_mjcf
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.tasks import walking
from learninghumanoidwalking_tpu_torch.utils.config import load_json


class MjcfWalkEnv(WalkingTaskMixin, HumanoidEnv):
    include_torque_obs = False

    def __init__(self, xml_path: str, path_to_json: str | None = None, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        # the robot file over the schema's defaults, so that it needs only
        # the robot's own keys
        self.cfg = load_config("mjcf_base.json", None)
        if path_to_json:
            self.cfg = self.cfg.merged(load_json(path_to_json))
        robot = self.cfg.robot
        if robot is None or robot.left_foot_geoms is None:
            raise ValueError(
                "mjcf env needs a JSON robot file with a `robot` section naming the left/right foot geoms and the "
                "root/foot bodies (see envs/configs/mjcf_base.json)"
            )
        self.spec = import_mjcf(
            xml_path,
            left_foot_geoms=tuple(robot.left_foot_geoms),
            right_foot_geoms=tuple(robot.right_foot_geoms),
            self_collision_pairs=tuple(tuple(p) for p in (robot.self_collision_pairs or [])),
        )
        self.model = lower(self.spec, device=self.device)

        self.ROOT_BODY = str(robot.root_body)
        self.HEAD_BODY = str(robot.head_body or robot.root_body)
        self.LFOOT_BODY = str(robot.lfoot_body)
        self.RFOOT_BODY = str(robot.rfoot_body)

        nu = self.model.nu
        kp = self.cfg.kp if self.cfg.kp is not None else [100.0] * nu
        kd = self.cfg.kd if self.cfg.kd is not None else [10.0] * nu
        self.kp = np.asarray(kp, dtype=np.float32)
        self.kd = np.asarray(kd, dtype=np.float32)
        if self.kp.shape != (nu,) or self.kd.shape != (nu,):
            raise ValueError(f"kp/kd must have {nu} entries (model actuators)")

        pose = np.deg2rad(np.asarray(self.cfg.half_sitting_pose or [0.0] * nu, dtype=np.float32))
        self.nominal_qpos = np.concatenate(
            [np.array([0, 0, float(robot.nominal_height)], np.float32), np.array([1, 0, 0, 0], np.float32), pose]
        )
        self.reward_names = walking.REWARD_NAMES
        self._finalize()
        self._setup_walking()

        # mirror lists only where the robot file gives both (indices over the
        # robot state; the external observations follow, as in the built-in envs)
        if robot.mirrored_obs is not None and robot.mirrored_acts is not None:
            base = list(robot.mirrored_obs)
            ext = [len(base) + i for i in range(self.num_external_obs)]
            self.clock_inds = ext[0:2]
            self.mirrored_obs = base + ext
            self.mirrored_acts = list(robot.mirrored_acts)
