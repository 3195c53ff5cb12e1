"""Where a PPO iteration's time goes, stage by stage, on the card
(counterpart of scripts/perf_probe.py): the same stages and JSON keys,
printed on one line, after a line with the workload and the kernel
stage's R (the JAX script's keys do not show R).

- ``sample``: ``PPO._sample_iteration`` (rollout, GAE, advantage norm);
- ``optimize``: ``PPO._optimize_iteration`` (the minibatched update), each
  call after a fresh ``_sample_iteration``, as the JAX script re-samples;
  ``train_fps`` is the env-steps/s of those sample + optimize calls. The
  JAX script takes optimize as their time less the sample stage's; here
  the update is timed itself (between two synchronizations), so the
  sampling's spread cannot leak into it;
- ``kernel``: ``rollout_len`` control steps of ``pd_substeps_kernel`` from
  ``nominal_qpos`` at rest with the model's default dynamics, toward
  ``neutral_pose``, at the env's factorization-reuse interval (the JAX
  script calls the Pallas kernel at its default R=1);
- ``envstep``: ``rollout_len`` calls of ``step_batch`` with zero actions
  (no nets, no auto-reset, no GAE);
- ``nets3x``: the actor and two critic forwards, ``rollout_len`` times, at
  the rollout's batch;
- ``gradstep48``: 48 loss, backward and Adam steps (``PPO._loss_fn``, the
  port's Adam) on one fixed contiguous minibatch;
- ``gather48``: 48 random-permutation minibatch gathers alone.

Each stage: one warm call, a synchronization, then ``n`` timed calls and a
synchronization before the clock is read (``timed``). The workload is
bench.py's: 32768 envs, rollout 16, minibatch 32768, max_traj_len 400.

  python -m learninghumanoidwalking_tpu_torch.perf_probe [--device cuda|cpu] [--num-envs N] [--rollout-len T]

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain physics, for the tests only (small ``--num-envs``
and ``--rollout-len``): its numbers are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

NUM_ENVS = 32768
ROLLOUT_LEN = 16
GRAD_STEPS = 48


def sync(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, n: int = 3) -> float:
    """Seconds a call of ``fn``: a warm call, then ``n`` calls, each run
    closed by a synchronization of ``device``."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / n


def kernel_inputs(env, num_envs: int):
    """The kernel stage's inputs on the env's device: the model's default
    dynamics for ``num_envs`` envs, the state at ``nominal_qpos`` with zero
    velocities, and ``neutral_pose`` as every env's target."""
    import numpy as np
    import torch

    from learninghumanoidwalking_tpu_torch.physics.engine import make_state
    from learninghumanoidwalking_tpu_torch.physics.model import default_dyn_params

    model, device = env.model, env.device
    qpos = torch.as_tensor(np.tile(np.asarray(env.nominal_qpos, np.float32)[None], (num_envs, 1)), device=device)
    state = make_state(model, qpos, torch.zeros((num_envs, model.nv), device=device))
    target = env.neutral_pose.expand(num_envs, -1).contiguous()
    return default_dyn_params(model, env.kp, env.kd, num_envs), state, target


def probe(device, num_envs: int = NUM_ENVS, rollout_len: int = ROLLOUT_LEN) -> dict:
    """The stages' times on ``device``; the JAX script's keys and rounding.
    Prints the workload's line first."""
    import torch

    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.ops.substep_kernel import pd_substeps_kernel
    from learninghumanoidwalking_tpu_torch.rl.ppo import PPO, PPOConfig
    from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

    env = make_env("jvrc_walk", device=device)
    cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout_len, minibatch_size=32768, max_traj_len=400)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ppo = PPO(env, cfg, device=device, draws=Draws(gen))
    print(f"perf_probe: jvrc_walk, {num_envs} envs x {rollout_len} steps, minibatch {cfg.minibatch_size}, kernel stage "
          f"at factorization reuse R={env.physics_reuse} (scripts/perf_probe.py: R=1)", flush=True)
    holder = {"ts": ppo.init_state()}
    steps = num_envs * rollout_len
    out = {}

    # ---- sample
    def run_sample():
        holder["ts"], holder["batch"], _ = ppo._sample_iteration(holder["ts"])

    dt_sample = timed(run_sample, device, n=5)
    out["sample_ms"] = round(dt_sample * 1e3, 1)
    out["sample_steps_per_s"] = round(steps / dt_sample, 0)

    # ---- optimize, each call on a fresh sample: the update timed itself
    opt_s = []

    def run_opt():
        ts, batch, _ = ppo._sample_iteration(holder["ts"])
        sync(device)
        t0 = time.perf_counter()
        holder["ts"], _ = ppo._optimize_iteration(ts, batch)
        sync(device)
        opt_s.append(time.perf_counter() - t0)

    dt_both = timed(run_opt, device, n=3)
    out["optimize_ms"] = round(1e3 * sum(opt_s[1:]) / 3, 1)
    out["train_fps"] = round(steps / dt_both, 0)

    # ---- the kernel alone: rollout_len control steps from rest
    dyn, state0, target = kernel_inputs(env, num_envs)

    def kernel_rollout():
        s = state0
        for _ in range(rollout_len):
            s = pd_substeps_kernel(env.model, dyn, s, target, env.frame_skip, env.sim_dt, reuse_interval=env.physics_reuse)

    dt = timed(kernel_rollout, device)
    out["kernel_ms"] = round(dt * 1e3, 1)
    out["kernel_steps_per_s"] = round(steps / dt, 0)

    # ---- the env step (kernel + task, observation, reward, randomization)
    env_state0 = holder["ts"].env_state
    zeros = torch.zeros((num_envs, env.action_size), device=device)

    def env_rollout():
        s = env_state0
        for _ in range(rollout_len):
            s = env.step_batch(s, zeros, ppo.draws)

    dt = timed(env_rollout, device)
    out["envstep_ms"] = round(dt * 1e3, 1)
    out["envstep_steps_per_s"] = round(steps / dt, 0)

    # ---- nets at the rollout's batch: the actor and two critic forwards
    ts = holder["ts"]
    obs = ts.env_state.obs

    @torch.no_grad()
    def nets():
        acc = torch.zeros(obs.shape[:1], device=device)
        for _ in range(rollout_len):
            mean, _ = ppo._policy(ts.actor, ts.norm, obs)
            v1 = ppo._value(ts.critic, ts.norm, obs)
            v2 = ppo._value(ts.critic, ts.norm, obs + acc[:, None])
            acc = acc + mean[:, 0] * 0 + v1 * 0 + v2 * 0

    out["nets3x_ms"] = round(timed(nets, device) * 1e3, 1)

    # ---- 48 gradient steps on one fixed contiguous minibatch
    batch = holder["batch"]
    flat = [x.reshape((cfg.batch_size,) + tuple(x.shape[2:])) for x in
            (batch.obs, batch.actions, batch.log_probs, batch.advantages, batch.returns)]
    mb0 = tuple(x[: cfg.minibatch_size] for x in flat)
    params = list(ts.actor.parameters()) + list(ts.critic.parameters())
    n_actor = len(list(ts.actor.parameters()))

    def gradsteps():
        for _ in range(GRAD_STEPS):
            loss, _ = ppo._loss_fn(ts.actor, ts.critic, ts.norm, mb0)
            grads = list(torch.autograd.grad(loss, params))
            ts.actor_opt.step(grads[:n_actor])
            ts.critic_opt.step(grads[n_actor:])

    out["gradstep48_ms"] = round(timed(gradsteps, device) * 1e3, 1)

    # ---- the 48 gathers alone
    obs_f, act_f, adv_f = flat[0], flat[1], flat[3]
    perm_gen = torch.Generator(device=device)
    perm_gen.manual_seed(1)

    def gathers():
        acc = torch.zeros((), device=device)
        for _ in range(GRAD_STEPS):
            idx = torch.randperm(cfg.batch_size, generator=perm_gen, device=device)[: cfg.minibatch_size]
            acc = acc + obs_f[idx].sum() + act_f[idx].sum() + adv_f[idx].sum()

    out["gather48_ms"] = round(timed(gathers, device) * 1e3, 1)
    return out


def main(argv=None) -> int:
    from learninghumanoidwalking_tpu_torch.run_experiment import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=NUM_ENVS)
    p.add_argument("--rollout-len", type=int, default=ROLLOUT_LEN)
    args = p.parse_args(argv)
    print(json.dumps(probe(resolve_device(args.device), args.num_envs, args.rollout_len)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
