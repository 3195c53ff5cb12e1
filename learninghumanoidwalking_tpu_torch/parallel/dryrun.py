"""One full data-parallel PPO iteration on a few ranks (counterpart of the
repository's __graft_entry__.py::dryrun_multichip for the JAX package).

    python -m learninghumanoidwalking_tpu_torch.parallel.dryrun 2 cpu
    python -m learninghumanoidwalking_tpu_torch.parallel.dryrun 4 cuda --against-one-rank

With ``--against-one-rank`` the same iteration also runs as one process
on the whole batch (the first device), and the largest relative
difference of the parameters and of the metrics is printed.
"""

from __future__ import annotations

import argparse
import time


def _iteration(shard, num_envs: int, device) -> dict:
    """One PPO iteration of jvrc_walk from the seed: rank 0's metrics and
    parameters (on the CPU), or the one-process run's with ``shard`` None."""
    import torch

    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.rl.ppo import PPO, PPOConfig

    device = shard.device if shard is not None else torch.device(device)
    env = make_env("jvrc_walk", device=device)
    cfg = PPOConfig(num_envs=num_envs, rollout_len=4, minibatch_size=2 * num_envs, epochs=1, max_traj_len=16)
    ppo = PPO(env, cfg, device=device, shard=shard)
    ts = ppo.init_state()
    ts, batch, roll = ppo._sample_iteration(ts)
    ts, aux = ppo._optimize_iteration(ts, batch)
    params = torch.cat([p.detach().reshape(-1) for p in list(ts.actor.parameters()) + list(ts.critic.parameters())])
    return dict(metrics={k: float(v) for k, v in {**roll, **aux}.items()}, params=params.cpu())


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One full PPO iteration (rollout, GAE, update) of jvrc_walk on
    ``n_devices`` ranks of ``device`` ("cuda": NCCL, one card a rank;
    "cpu": gloo) at 8 envs a rank, rollout 4, a minibatch of twice the
    envs, 1 epoch, episodes of at most 16 steps; prints the JAX function's
    line and returns rank 0's metrics and parameters. The JAX function
    also checks that a second iteration does not recompile: the port
    compiles nothing per shape (its kernels are built once per source), so
    that check has no counterpart here."""
    from learninghumanoidwalking_tpu_torch.parallel.mesh import launch

    t0 = time.time()
    num_envs = 8 * n_devices
    out = launch(_iteration, n_devices, device, num_envs, num_envs, device)
    print(
        f"dryrun_multichip({n_devices}): full PPO iteration OK ({num_envs} envs sharded over {n_devices} devices); "
        f"mean_reward={out['metrics']['mean_reward']:.4f}; wall={time.time() - t0:.1f}s",
        flush=True,
    )
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("device", nargs="?", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--against-one-rank", action="store_true", help="also run the whole batch in one process and compare")
    args = p.parse_args(argv)
    ranks = dryrun_multichip(args.n_devices, args.device)
    if args.against_one_rank:
        one = _iteration(None, 8 * args.n_devices, args.device)
        p_err = float((ranks["params"] - one["params"]).abs().max() / one["params"].abs().max())
        m_err = max(abs(ranks["metrics"][k] - v) / max(abs(v), 1.0) for k, v in one["metrics"].items())
        print(f"{args.n_devices} ranks against one process on the whole batch: parameters max relative difference "
              f"{p_err:.3g}, metrics max difference over max(1, |metric|) {m_err:.3g}", flush=True)


if __name__ == "__main__":
    main()
