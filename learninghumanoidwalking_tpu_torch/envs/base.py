"""Env state and base class (counterpart of learninghumanoidwalking_tpu/envs/base.py).

The JAX env is a pure function of one env's state, vmapped over the batch.
Here the batch axis is written out: every EnvState field is batch-leading.
The envs have two pairs of entry points, as the JAX package has:
``reset``/``step``, the engine path (the counterparts of ``jax.vmap`` over
the JAX env's single-env ``reset``/``step``: one engine step at a time,
physics/batched.py ``engine_step_b``), and ``reset_batch``/``step_batch``,
the training path (the control-step kernel). Randomness comes from a
``Draws`` source (utils/seeding.py) instead of a per-env PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class EnvState:
    """Per-env dynamic state, batch-leading (B, ...)."""

    physics: Any  # PhysicsState
    dyn: Any  # DynParams
    task: Any  # task state (WalkingState)
    obs: torch.Tensor  # (B, obs_size)
    obs_history: torch.Tensor  # (B, history_len, base_obs_len)
    prev_prediction: torch.Tensor  # (B, nu)
    prev_action: torch.Tensor  # (B, nu)
    prev_torque: torch.Tensor  # (B, nu)
    reward: torch.Tensor  # (B,)
    reward_components: torch.Tensor  # (B, n_terms)
    done: torch.Tensor  # (B,) bool
    steps: torch.Tensor  # (B,) int32
    iteration: torch.Tensor  # (B,) int32
    motor: Any = None  # MotorState (batch-leading) when the motor-dynamics hook is enabled


class Env:
    """Static environment definition (see the JAX Env for the attribute contract)."""

    obs_mean = None
    obs_std = None
    mirrored_obs = None
    mirrored_acts = None
    clock_inds = None

    def reset(self, num_envs: int, draws, iteration=None) -> EnvState:
        raise NotImplementedError

    def step(self, states: EnvState, actions: torch.Tensor, draws) -> EnvState:
        raise NotImplementedError

    def reset_batch(self, num_envs: int, draws, iteration=None) -> EnvState:
        raise NotImplementedError

    def step_batch(self, states: EnvState, actions: torch.Tensor, draws) -> EnvState:
        raise NotImplementedError

    def stack_history(self, obs_history: torch.Tensor, obs: torch.Tensor):
        """Push obs (B, L) into the rolling history (B, H, L), newest first."""
        new_hist = torch.roll(obs_history, 1, dims=1)
        new_hist[:, 0] = obs
        return new_hist, new_hist.reshape(new_hist.shape[0], -1)
