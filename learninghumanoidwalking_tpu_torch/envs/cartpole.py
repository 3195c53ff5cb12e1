"""Cartpole swing-up environment (counterpart of learninghumanoidwalking_tpu/envs/cartpole.py).

  * sim_dt 5 ms, control_dt 20 ms (frame_skip 4), each substep one engine
    step (physics/batched.py ``engine_step_b``, the JAX ``engine.step``;
    plain PyTorch on the card too: no control-step kernel carries cartpole,
    in the JAX package either). So ``reset``/``step`` are the env, and the
    training path's ``reset_batch``/``step_batch`` call them
  * obs (5,): [cart_pos, cos(angle), sin(angle), cart_vel, pole_vel]
  * action (1,): target cart position, clipped to +-0.8 before PD
  * PD kp=100 kd=10 at joint level, applied directly as ctrl (not divided
    by the gear, so the actuator multiplies the PD torque by 50)
  * reward: upright (linear + exp), center, velocity and action terms
  * termination: |cart_pos| > 0.99
  * no fixed obs_mean/obs_std: PPO runs its observation-norm warmup
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.envs.base import Env, EnvState
from learninghumanoidwalking_tpu_torch.models.cartpole import cartpole_spec
from learninghumanoidwalking_tpu_torch.physics import batched, engine
from learninghumanoidwalking_tpu_torch.physics.model import default_dyn_params
from learninghumanoidwalking_tpu_torch.physics.spec import lower

REWARD_NAMES = ("upright", "center", "velocity", "action")


class CartpoleEnv(Env):
    def __init__(self, path_to_json: str | None = None, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.sim_dt = 0.005
        self.control_dt = 0.02
        self.frame_skip = int(round(self.control_dt / self.sim_dt))
        self.spec = cartpole_spec()
        self.model = lower(self.spec, device=self.device)
        self.kp = np.array([100.0], np.float32)
        self.kd = np.array([10.0], np.float32)
        self.base_obs_len = 5
        self.history_len = 1
        self.obs_size = 5
        self.action_size = 1
        self.reward_names = REWARD_NAMES

    @staticmethod
    def _obs(physics) -> torch.Tensor:
        x, theta = physics.qpos[:, 0], physics.qpos[:, 1]
        return torch.stack([x, torch.cos(theta), torch.sin(theta), physics.qvel[:, 0], physics.qvel[:, 1]], dim=-1)

    def reset(self, num_envs: int, draws, iteration=None) -> EnvState:
        """Fresh states: the pole at U(-pi, pi), then U(-0.1, 0.1) on both
        coordinates and both velocities."""
        n, dev = num_envs, self.device
        pole = draws.uniform("init.pole", (n,), -math.pi, math.pi, dev)
        qpos = torch.stack([torch.zeros_like(pole), pole], dim=-1) + draws.uniform("init.qpos", (n, 2), -0.1, 0.1, dev)
        qvel = draws.uniform("init.qvel", (n, 2), -0.1, 0.1, dev)
        physics = engine.make_state(self.model, qpos, qvel)
        obs = self._obs(physics)
        if iteration is None:
            iteration = torch.zeros((n,), dtype=torch.int32, device=dev)
        zeros = lambda *shape: torch.zeros((n,) + shape, device=dev)
        return EnvState(
            physics=physics,
            dyn=default_dyn_params(self.model, self.kp, self.kd, n),
            task=None,
            obs=obs,
            obs_history=obs[:, None],
            prev_prediction=zeros(1),
            prev_action=zeros(1),
            prev_torque=zeros(1),
            reward=zeros(),
            reward_components=zeros(len(REWARD_NAMES)),
            done=torch.zeros((n,), dtype=torch.bool, device=dev),
            steps=torch.zeros((n,), dtype=torch.int32, device=dev),
            iteration=torch.as_tensor(iteration, dtype=torch.int32, device=dev).expand(n).clone(),
        )

    def step(self, states: EnvState, actions: torch.Tensor, draws=None) -> EnvState:
        """One control step: ``frame_skip`` PD substeps of ``engine_step_b``
        with the env's gains (``dyn.kp``/``dyn.kd``, which cartpole never
        randomizes). Cartpole draws nothing here."""
        target = torch.clamp(actions, -0.8, 0.8)
        physics, kp, kd = states.physics, states.dyn.kp, states.dyn.kd
        for _ in range(self.frame_skip):
            tau = kp * (target - physics.qpos[:, :1]) + kd * (0.0 - physics.qvel[:, :1])
            physics = batched.engine_step_b(self.model, states.dyn, physics, tau, self.sim_dt)
        obs = self._obs(physics)
        components = self._reward(obs, target)
        return dataclasses.replace(
            states,
            physics=physics,
            obs=obs,
            obs_history=obs[:, None],
            prev_prediction=actions,
            prev_action=target,
            reward=torch.sum(components, dim=-1),
            reward_components=components,
            done=torch.abs(obs[:, 0]) > 0.99,
            steps=states.steps + 1,
        )

    def reset_batch(self, num_envs: int, draws, iteration=None) -> EnvState:
        return self.reset(num_envs, draws, iteration)

    def step_batch(self, states: EnvState, actions: torch.Tensor, draws=None) -> EnvState:
        return self.step(states, actions, draws)

    @staticmethod
    def _reward(obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        cart_pos, cos_angle, pole_vel = obs[:, 0], obs[:, 1], obs[:, 4]
        # the linear part gives a gradient from any angle, the exp part
        # sharpens it near upright
        upright = 0.35 * (1.0 + cos_angle) / 2.0 + 0.35 * torch.exp(-2.0 * (1.0 - cos_angle) ** 2)
        center = 0.1 * torch.exp(-2.0 * cart_pos**2)
        velocity = 0.1 * torch.exp(-0.05 * pole_vel**2)
        action_r = 0.1 * torch.exp(-torch.sum(action**2, dim=-1))
        return torch.stack([upright, center, velocity, action_r], dim=-1)
