"""Training A/B harness (counterpart of scripts/benchmark_training.py).

``run`` trains one env for ``--n-itr`` PPO iterations (after the running
norm's warmup where the env has no fixed observation statistics) and
records, per iteration, env-steps/s, the mean reward per step and the
iteration's seconds, taken once the reward has reached the host (the copy
waits for the device); it writes them as JSON with the run's average fps
(iteration 0 left out) and final reward. ``compare`` prints two such files
side by side: the same code on two trees, or two variants of a path. On a
humanoid env every control step runs the control-step kernel, as training
does.

  python -m learninghumanoidwalking_tpu_torch.training_ab run --env cartpole --n-itr 50 --out a.json [--device cuda|cpu]
  python -m learninghumanoidwalking_tpu_torch.training_ab compare a.json b.json

``--device`` defaults to ``cuda``; without a card that raises, as the
port's command line does (pass ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path


def run(args) -> dict:
    """Train as ``args`` say, write the result to ``args.out`` and return it."""
    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.rl.ppo import PPO, PPOConfig
    from learninghumanoidwalking_tpu_torch.run_experiment import resolve_device

    device = resolve_device(args.device)
    env = make_env(args.env, device=device)
    cfg = PPOConfig(
        num_envs=args.num_envs,
        rollout_len=args.rollout_len,
        minibatch_size=args.minibatch_size,
        max_traj_len=args.max_traj_len,
        seed=args.seed,
        input_norm_iters=2,
    )
    ppo = PPO(env, cfg, device=device)
    ts = ppo.init_state()
    if env.obs_mean is None:
        for _ in range(cfg.input_norm_iters):
            ts = ppo._warmup_iteration(ts)

    records = []
    t_start = time.time()
    for itr in range(args.n_itr):
        t0 = time.time()
        ts, metrics = ppo._train_iter(ts)
        reward = float(metrics["mean_reward"])
        dt = time.time() - t0
        fps = cfg.batch_size / dt
        records.append({"itr": itr, "fps": fps, "mean_reward": reward, "iter_time": dt})
        if itr % 10 == 0:
            print(f"itr {itr}: fps {fps:,.0f} reward {reward:.3f}", flush=True)

    result = {
        "env": args.env,
        "config": {k: str(v) if isinstance(v, Path) else v for k, v in vars(args).items()},
        "total_time": time.time() - t_start,
        "avg_fps": sum(r["fps"] for r in records[1:]) / max(len(records) - 1, 1),
        "final_reward": records[-1]["mean_reward"],
        "records": records,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"avg fps {result['avg_fps']:,.0f} | final reward {result['final_reward']:.3f} | saved {args.out}")
    return result


def compare(path_a: str, path_b: str) -> None:
    a, b = json.load(open(path_a)), json.load(open(path_b))
    print(f"{'metric':20s} {'A':>14s} {'B':>14s} {'B/A':>8s}")
    for key in ("avg_fps", "final_reward", "total_time"):
        va, vb = a[key], b[key]
        ratio = vb / va if va else float("nan")
        print(f"{key:20s} {va:14.2f} {vb:14.2f} {ratio:8.3f}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["run"])
    p.add_argument("--env", default="cartpole")
    p.add_argument("--n-itr", type=int, default=50)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--rollout-len", type=int, default=32)
    p.add_argument("--minibatch-size", type=int, default=2048)
    p.add_argument("--max-traj-len", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path, default=Path(tempfile.gettempdir()) / "bench_result.json")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu; cuda without a card is an error")
    return p


def main(argv=None) -> dict | None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["compare"]:
        compare(argv[1], argv[2])
        return None
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
