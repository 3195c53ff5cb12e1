"""Generalized Advantage Estimation (counterpart of learninghumanoidwalking_tpu/rl/gae.py).

The JAX reverse ``lax.scan`` over time is a reverse Python loop here.
``next_values`` is the critic value of the post-step (pre-reset)
observation, zeroed only for true terminations; ``done`` cuts the
advantage recursion at truncations too.
"""

from __future__ import annotations

import torch


def compute_gae(rewards, values, next_values, terminated, done, gamma: float, lam: float):
    """All inputs (T, B). Returns (advantages, returns), each (T, B)."""
    term = terminated.to(rewards.dtype)
    cut = done.to(rewards.dtype)
    adv = torch.zeros_like(rewards[0])
    out = [None] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_values[t] * (1.0 - term[t]) - values[t]
        adv = delta + gamma * lam * (1.0 - cut[t]) * adv
        out[t] = adv
    advantages = torch.stack(out)
    return advantages, advantages + values
