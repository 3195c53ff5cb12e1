"""Policy loading and replay (counterpart of learninghumanoidwalking_tpu/rl/eval.py).

``load_policy`` rebuilds a run's env and actor (feed-forward or LSTM) from
its experiment.json and a checkpoint (best.pt first); ``load_expert`` gives
a frozen feed-forward expert for imitation and refuses a recurrent one, as
the JAX package does; ``evaluate_policy`` replays the deterministic policy
for a few episodes, run as one batch of envs through ``step_batch`` (on the
card, through the control-step kernel), a recurrent policy with its carry,
and writes each episode's qpos trajectory to an .npz, or renders episode 0
with its task markers to a video (rl/render.py). The live viewer is
rl/viewer.py.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.rl.checkpoint import Checkpointer, find_latest_run
from learninghumanoidwalking_tpu_torch.rl.ppo import PPO, PPOConfig
from learninghumanoidwalking_tpu_torch.utils.seeding import EnvDraws


class DeterministicPolicy:
    """Observations -> action means of an actor under its own observation
    norm, without gradients."""

    def __init__(self, actor: torch.nn.Module, norm):
        self.actor = actor
        self.norm = norm

    @torch.no_grad()
    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor(self.norm.normalize(obs))[0]


class RecurrentPolicy:
    """A deterministic LSTM policy with an explicit carry: ``init_carry(n)``
    gives zero carries for n envs, ``apply(carry, obs) -> (carry, mean)``."""

    def __init__(self, ppo: PPO, actor: torch.nn.Module, norm):
        self._ppo = ppo
        self.actor = actor
        self.norm = norm

    def init_carry(self, batch: int = 1) -> tuple:
        return self._ppo.initial_carry(batch)

    @torch.no_grad()
    def apply(self, carry, obs: torch.Tensor):
        carry, (mean, _) = self.actor(carry, self.norm.normalize(obs))
        return carry, mean


def load_policy(path: str | Path, best: bool = True, device: str | torch.device = "cuda"):
    """(policy, TrainState without env batch, (env, meta)) of the latest run
    under ``path`` (or the run ``path`` itself): best.pt if asked and
    present, else the latest checkpoint. The policy is a DeterministicPolicy,
    or a RecurrentPolicy for a recurrent run."""
    run_dir = find_latest_run(path)
    if run_dir is None:
        raise FileNotFoundError(f"no runs found under {path}")
    meta = Checkpointer.load_experiment(run_dir)
    env = make_env(meta["env"], meta.get("json"), device=device)
    cfg = PPOConfig(
        num_envs=1,
        rollout_len=1,
        std_dev=meta.get("std_dev", 0.223),
        learn_std=meta.get("learn_std", False),
        seed=meta.get("seed", 0) or 0,
        net_dtype=meta.get("net_dtype", "bfloat16"),
        hidden=tuple(meta.get("hidden", (256, 256))),
        recurrent=meta.get("recurrent", False),
    )
    ppo = PPO(env, cfg, device=device)
    ck = Checkpointer(run_dir)
    target = ppo.init_networks()
    try:
        ts = ck.restore(target, best=best)
    except FileNotFoundError:
        ts = ck.restore(target)
    policy = RecurrentPolicy(ppo, ts.actor, ts.norm) if cfg.recurrent else DeterministicPolicy(ts.actor, ts.norm)
    return policy, ts, (env, meta)


def load_expert(path: str | Path, best: bool = True, device: str | torch.device = "cuda"):
    """A frozen feed-forward expert for imitation: (policy, (env, meta)).
    A recurrent expert raises ValueError, as in the JAX package."""
    policy, _, (env, meta) = load_policy(path, best=best, device=device)
    if meta.get("recurrent", False):
        raise ValueError(f"imitation expert at {path} is recurrent; only FF experts are supported")
    return policy, (env, meta)


def evaluate_policy(path: str | Path, episodes: int = 3, max_steps: int = 400, out: str | Path | None = None,
                    device: str | torch.device = "cuda") -> dict:
    """Replay the deterministic policy of ``path`` for ``episodes`` episodes
    of at most ``max_steps`` steps, as one batch: episode i's draws come from
    a generator seeded with 1000 + i, and its trajectory ends at its first
    ``done``. Writes the qpos trajectories to ``out`` (.npz, ``episode_<i>``
    of shape (length_i, nq)), or, for an ``out`` of .gif or .mp4, renders
    episode 0 with its task markers (``env.render_markers`` of env 0 at each
    of its steps) through rl/render.py. Returns the trajectories, the
    episode rewards and lengths, the control steps run, episode 0's markers
    (None unless rendering) and the renderer that drew the video."""
    video = out is not None and Path(out).suffix in (".mp4", ".gif")
    if video:
        from learninghumanoidwalking_tpu_torch.rl.render_gl import check_writer

        check_writer(Path(out))
    policy, _, (env, meta) = load_policy(path, device=device)
    recurrent = isinstance(policy, RecurrentPolicy)
    print(f"evaluating {meta['env']} policy from {path}" + (" (recurrent)" if recurrent else ""), flush=True)
    dev = torch.device(device)
    gens = []
    for ep in range(episodes):
        gens.append(torch.Generator(device=dev))
        gens[-1].manual_seed(1000 + ep)
    draws = EnvDraws(gens)
    state = env.reset_batch(episodes, draws)
    alive = torch.ones(episodes, dtype=torch.bool, device=dev)
    total = torch.zeros(episodes, device=dev)
    length = torch.zeros(episodes, dtype=torch.int64, device=dev)
    qpos = []
    steps = 0
    carry = policy.init_carry(episodes) if recurrent else None
    render_markers = getattr(env, "render_markers", lambda states, i: None)
    markers = [] if video else None
    while steps < max_steps and bool(alive.any()):
        if recurrent:
            carry, action = policy.apply(carry, state.obs)
        else:
            action = policy(state.obs)
        state = env.step_batch(state, action, draws)
        steps += 1
        total = total + torch.where(alive, state.reward, 0.0)
        length = length + alive.long()
        qpos.append(state.physics.qpos.cpu())
        if video and bool(alive[0]):
            markers.append(render_markers(state, 0))
        alive = alive & ~state.done
    traj = torch.stack(qpos).numpy() if qpos else np.zeros((0, episodes, env.model.nq), np.float32)
    lengths = length.cpu().tolist()
    rewards = total.cpu().tolist()
    trajectories = [traj[: lengths[i], i] for i in range(episodes)]
    for i in range(episodes):
        print(f"episode {i}: reward {rewards[i]:.2f}  length {lengths[i]}", flush=True)
    renderer = None
    if video:
        from learninghumanoidwalking_tpu_torch.rl.render import render_trajectory

        out, renderer = render_trajectory(env, trajectories[0], out, markers=markers)
        print(f"rendered episode 0 to {out} ({renderer})", flush=True)
    elif out is not None:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out, **{f"episode_{i}": q for i, q in enumerate(trajectories)})
        print(f"wrote trajectories to {out}", flush=True)
    return dict(trajectories=trajectories, rewards=rewards, lengths=lengths, steps=steps, markers=markers,
                renderer=renderer)
