"""Matmul operations of the actor and critic in one PPO iteration, from the shapes.

The feed-forward actor (obs -> hidden... -> actions) and critic (obs ->
hidden... -> 1). A Linear of i inputs and o outputs costs 2 i o operations a
sample forward, 2 i o for its weight gradient and 2 i o for its input
gradient (not needed at the first layer, whose input is data). The mirror
loss adds the actor on mirrored observations and the two mirror products.
Elementwise work (activations, losses, Adam) is not counted: this is the
least matmul work, held to the bfloat16 tensor peak.
"""

from __future__ import annotations


def _layers(obs: int, hidden: list[int], out: int) -> list[tuple[int, int]]:
    dims = [obs, *hidden, out]
    return list(zip(dims[:-1], dims[1:]))


def forward_ops(obs: int, hidden: list[int], out: int) -> float:
    return float(sum(2 * i * o for i, o in _layers(obs, hidden, out)))


def train_ops(obs: int, hidden: list[int], out: int) -> float:
    """Forward and backward of one sample."""
    layers = _layers(obs, hidden, out)
    return float(sum(2 * i * o * (2 if k == 0 else 3) for k, (i, o) in enumerate(layers)))


def iteration_ops(obs: int, act: int, hidden: list[int], num_envs: int, rollout_len: int,
                  minibatch: int, epochs: int, mirror: bool) -> dict:
    """{"rollout": ..., "update": ...}: the rollout runs the actor on every
    step's observations and the critic on every stepped observation, plus
    the critic once on the reset pool and once on the first observations;
    the update runs epochs x (batch / minibatch) gradient steps of
    ``minibatch`` samples."""
    actor_f, critic_f = forward_ops(obs, hidden, act), forward_ops(obs, hidden, 1)
    rollout = rollout_len * num_envs * (actor_f + critic_f) + 2 * num_envs * critic_f
    per_sample = train_ops(obs, hidden, act) + train_ops(obs, hidden, 1)
    if mirror:
        per_sample += train_ops(obs, hidden, act) + 2 * obs * obs + 2 * 2 * act * act
    steps = epochs * max(num_envs * rollout_len // minibatch, 1)
    return {"rollout": float(rollout), "update": float(steps * minibatch * per_sample)}
