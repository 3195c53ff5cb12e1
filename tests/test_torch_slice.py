"""CPU smoke of the port's training paths: PPO on jvrc_walk, jvrc_step,
jvrc_walk_rough, jvrc_walk with the learned motor model, h1 and h1_walk
through the same
entry points chip_smoke.py drives on the card (make_env -> PPO -> train),
at a small size: a few envs, a short rollout, 2 iterations, (32, 32)
networks.

On the CPU the physics runs the plain version, so the K1-K4 launch
counters must stay at 0; every loss must be finite.
"""

import math
import os

import pytest
import torch

from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.ops import substep_kernel
from learninghumanoidwalking_tpu_torch.rl.ppo import PPO, PPOConfig
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)


def test_two_training_iterations_on_cpu():
    env = make_env("jvrc_walk", device="cpu")
    cfg = PPOConfig(num_envs=8, rollout_len=4, minibatch_size=16, epochs=2, net_dtype="float32",
                    hidden=(32, 32), input_norm_iters=1, seed=0)
    trainer = PPO(env, cfg, device="cpu")
    for c in substep_kernel.counters.values():
        c.reset()
    before = [p.detach().clone() for p in trainer.init_state().actor.parameters()]
    ts, history = trainer.train(2, verbose=False, evaluate=False)
    assert all(c.launches == 0 for c in substep_kernel.counters.values())
    assert len(history) == 2 and ts.iteration == 2
    for m in history:
        for k in ("actor_loss", "critic_loss", "mirror_loss", "approx_kl", "mean_reward"):
            assert math.isfinite(m[k]), (k, m[k])
    after = list(ts.actor.parameters())
    assert any(float((a.detach() - b).abs().max()) > 0 for a, b in zip(after, before))
    assert ts.env_state.obs.shape == (8, 37) and torch.isfinite(ts.env_state.obs).all()
    assert int(ts.env_state.iteration[0]) == 2


@pytest.mark.parametrize("name, obs_size", [("jvrc_step", 39), ("jvrc_walk_rough", 37)])
def test_two_terrain_training_iterations_on_cpu(name, obs_size):
    env = make_env(name, device="cpu")
    cfg = PPOConfig(num_envs=4, rollout_len=3, minibatch_size=6, epochs=1, net_dtype="float32",
                    hidden=(32, 32), seed=0)
    trainer = PPO(env, cfg, device="cpu")
    for c in substep_kernel.counters.values():
        c.reset()
    ts, history = trainer.train(2, verbose=False, evaluate=False)
    assert all(c.launches == 0 for c in substep_kernel.counters.values())
    assert len(history) == 2 and ts.iteration == 2
    for m in history:
        for k in ("actor_loss", "critic_loss", "mirror_loss", "approx_kl", "mean_reward"):
            assert math.isfinite(m[k]), (k, m[k])
    assert ts.env_state.obs.shape == (4, obs_size) and torch.isfinite(ts.env_state.obs).all()
    assert env._terrain(ts.env_state.task).floor_z.shape == (4,)


def test_warmup_iteration_updates_running_norm():
    """The obs-norm warmup (run by train() for envs without fixed obs
    statistics) merges rollout observations into the running norm."""
    env = make_env("jvrc_walk", device="cpu")
    cfg = PPOConfig(num_envs=4, rollout_len=2, net_dtype="float32", hidden=(16, 16))
    trainer = PPO(env, cfg, device="cpu")
    ts = trainer.init_state()
    assert trainer.warmup_iterations() == 0  # jvrc_walk ships fixed obs statistics
    count0 = float(ts.norm.count)
    ts = trainer._warmup_iteration(ts)
    assert float(ts.norm.count) == count0 + 8
    assert torch.isfinite(ts.norm.mean).all() and torch.isfinite(ts.norm.var).all()


def test_two_motor_training_iterations_on_cpu():
    """jvrc_walk with the motor config (motor model and PD-gain
    randomization on). An env that finishes inside the rollout restarts
    from the reset pool with a fresh MotorState (count 0): env 0 is made to
    finish at every step, so it ends the rollout at count 0 while the
    others count 25 substeps a step."""
    from learninghumanoidwalking_tpu_torch.envs.humanoid import CONFIG_DIR

    env = make_env("jvrc_walk", path_to_json=os.path.join(CONFIG_DIR, "jvrc_motor.json"), device="cpu")
    assert env.motor_enabled and env.pdrand_k > 0
    cfg = PPOConfig(num_envs=4, rollout_len=3, minibatch_size=6, epochs=1, net_dtype="float32",
                    hidden=(32, 32), seed=0)
    trainer = PPO(env, cfg, device="cpu")
    for c in substep_kernel.counters.values():
        c.reset()
    ts, history = trainer.train(2, verbose=False, evaluate=False)
    assert all(c.launches == 0 for c in substep_kernel.counters.values())
    assert set(substep_kernel.counters) == {"K1", "K2", "K3", "K4", "K5", "K6"}
    assert len(history) == 2 and ts.iteration == 2
    for m in history:
        for k in ("actor_loss", "critic_loss", "mirror_loss", "approx_kl", "mean_reward"):
            assert math.isfinite(m[k]), (k, m[k])
    assert ts.env_state.obs.shape == (4, 37) and torch.isfinite(ts.env_state.obs).all()
    count = ts.env_state.motor.count
    assert count.dtype == torch.int32 and ts.env_state.motor.qdot_hist.shape == (4, 25, 12)
    assert int(count.min()) >= 75  # at least the last rollout of 3 steps: 25 substeps a step

    done = env._done
    env._done = lambda physics: done(physics) | (torch.arange(4) == 0)
    env_state, traj = trainer._rollout(ts, deterministic=True)
    assert bool(traj["done"][:, 0].all()) and not bool(traj["done"][:, 1:].any())
    assert env_state.motor.count.tolist() == [0] + [int(c) + 75 for c in count[1:]]
    assert float(env_state.motor.ctau_hist[0].abs().max()) == 0.0


@pytest.mark.parametrize("name, obs_size", [("h1", 35), ("h1_walk", 43)])
def test_two_h1_training_iterations_on_cpu(name, obs_size):
    """H1 (dynamics randomization, perturbation wrenches and torque
    observations on), evaluated at both iterations."""
    env = make_env(name, device="cpu")
    cfg = PPOConfig(num_envs=4, rollout_len=2, minibatch_size=4, epochs=1, net_dtype="float32",
                    hidden=(32, 32), max_traj_len=2, eval_freq=1, seed=0)
    trainer = PPO(env, cfg, device="cpu")
    for c in substep_kernel.counters.values():
        c.reset()
    ts, history = trainer.train(2, verbose=False)
    assert all(c.launches == 0 for c in substep_kernel.counters.values())
    assert len(history) == 2 and ts.iteration == 2
    for m in history:
        for k in ("actor_loss", "critic_loss", "mirror_loss", "approx_kl", "mean_reward", "eval_mean_reward"):
            assert math.isfinite(m[k]), (k, m[k])
        assert m["eval_mean_episode_length"] <= 2
    assert ts.env_state.obs.shape == (4, obs_size) and torch.isfinite(ts.env_state.obs).all()
    assert (history[0]["mirror_loss"] > 0) == (name == "h1_walk")  # only h1_walk has mirror lists
