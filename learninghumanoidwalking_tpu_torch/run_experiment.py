"""The port's command line: train / eval (counterpart of the repository's
run_experiment.py for the JAX package).

  python -m learninghumanoidwalking_tpu_torch.run_experiment train --env h1 --logdir logs
  python -m learninghumanoidwalking_tpu_torch.run_experiment train --env mjcf:robot.xml --json robot.json
  python -m learninghumanoidwalking_tpu_torch.run_experiment train --env jvrc_walk --n-devices 4
  python -m learninghumanoidwalking_tpu_torch.run_experiment eval --path logs --out traj.npz
  python -m learninghumanoidwalking_tpu_torch.run_experiment eval --path logs --out episode.gif
  python -m learninghumanoidwalking_tpu_torch.run_experiment eval --path logs --view

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; ``cpu``
only when asked, and ``cuda`` without a card is an error, never a
fallback). Differences, each also in ``--help``: ``--json`` takes the place
of ``--yaml`` (the port's configs are JSON); the log is JSON lines, not
TensorBoard events. ``--n-devices N`` trains data parallel on N ranks, one
process a device (NCCL on N cards, gloo on the CPU with ``--device cpu``;
parallel/mesh.py), which computes what one device does on the whole
batch. ``eval --out`` of .gif / .mp4 renders episode 0 with its task
markers (rl/render.py; .mp4 needs an ffmpeg writer for imageio), ``eval
--view`` replays in a live window (rl/viewer.py; needs a display).
``--recurrent`` trains LSTM policies, stored in
experiment.json as the JAX CLI stores it, and ``eval`` replays them.
``--env mjcf:<path>`` builds a walking env from an MJCF robot file, whose
JSON robot file ``--json`` names; experiment.json keeps both as absolute
paths, so that ``eval --path`` and ``--continued`` build the same env. A
model past the kernel's caps raises the kernel's message on ``cuda``.
"""

from __future__ import annotations

import argparse
import datetime
import platform
import sys
import tempfile
from pathlib import Path

def resolve_device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to run on the CPU)")
    return device


def system_banner(device) -> None:
    import torch

    print("=" * 60)
    print(f"python {platform.python_version()} | torch {torch.__version__} | cuda {torch.version.cuda}")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    print("=" * 60, flush=True)


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train", description="Train a policy with PPO (the JAX CLI's flags; see the differences noted per flag).")
    p.add_argument("--env", required=True, type=str,
                   help="a registered env (jvrc_walk, jvrc_step, jvrc_walk_rough, h1, h1_walk, cartpole) or mjcf:<path to an "
                        "MJCF robot file>, whose robot roles --json names (schema: envs/configs/mjcf_base.json)")
    p.add_argument("--logdir", default=Path(tempfile.gettempdir()) / "logs", type=Path)
    p.add_argument("--n-itr", type=int, default=20000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--eps", type=float, default=1e-5)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--lam", type=float, default=0.95)
    p.add_argument("--std-dev", type=float, default=0.223)
    p.add_argument("--learn-std", action="store_true")
    p.add_argument("--entropy-coeff", type=float, default=0.0)
    p.add_argument("--clip", type=float, default=0.2)
    p.add_argument("--minibatch-size", type=int, default=4096)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--num-envs", type=int, default=1024, help="parallel envs on the device")
    p.add_argument("--rollout-len", type=int, default=64, help="steps per env per iteration")
    p.add_argument("--max-grad-norm", type=float, default=0.5)
    p.add_argument("--max-traj-len", type=int, default=400)
    p.add_argument("--no-mirror", action="store_true")
    p.add_argument("--mirror-coeff", type=float, default=0.4)
    p.add_argument("--eval-freq", type=int, default=100)
    p.add_argument("--continued", type=Path, default=None, help="logdir of a run to resume (its latest run with checkpoints)")
    p.add_argument("--recurrent", action="store_true", help="LSTM actor and critic")
    p.add_argument("--imitate", type=str, default=None, help="logdir of an expert run to imitate")
    p.add_argument("--imitate-coeff", type=float, default=0.3)
    p.add_argument("--json", type=str, default=None, help="env config file (JSON; takes the place of the JAX CLI's --yaml); with --env mjcf:<path>, the robot file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks, one process a device (NCCL on cuda:0..N-1, gloo with --device cpu); "
                        "--num-envs must split evenly")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="trace training iterations 2-4 with torch.profiler into this directory (Chrome trace, trace.json)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu; cuda without a card is an error")
    return p


def train(argv, on_iteration=None) -> dict:
    """Parse ``argv`` and train. Returns the run directory, the final
    TrainState, the per-iteration metrics and, with --continued, the run
    resumed and the iteration it resumed at. With --n-devices above 1 the
    ranks run in processes of their own and the TrainState stays there
    (``ts`` None): the metrics and the iteration are rank 0's.
    ``on_iteration(itr, metrics)`` sees each iteration's metrics (PPO.train's
    hook; one rank only, so not with --n-devices above 1)."""
    args = build_train_parser().parse_args(argv)
    device = resolve_device(args.device)
    n_ranks = args.n_devices or 1
    if n_ranks > 1 and on_iteration is not None:
        raise ValueError("on_iteration needs one rank (no --n-devices)")
    if n_ranks > 1:
        from learninghumanoidwalking_tpu_torch.parallel.mesh import check_layout

        check_layout(args.num_envs, n_ranks, device.type)
    system_banner(device)

    if args.env.startswith("mjcf:"):  # absolute paths: eval --path and --continued rebuild the env from anywhere
        args.env = "mjcf:" + str(Path(args.env[len("mjcf:"):]).resolve())
        args.json = None if args.json is None else str(Path(args.json).resolve())
    run_name = "mjcf-" + Path(args.env[len("mjcf:"):]).stem if args.env.startswith("mjcf:") else args.env
    run_dir = Path(args.logdir) / f"{run_name}-{datetime.datetime.now():%Y%m%d-%H%M%S-%f}"
    run_dir.mkdir(parents=True, exist_ok=True)
    print(f"logging to {run_dir}", flush=True)
    if n_ranks == 1:
        return _train_run(args, device, run_dir, on_iteration=on_iteration)
    from learninghumanoidwalking_tpu_torch.parallel.mesh import launch

    print(f"training on {n_ranks} ranks, {args.num_envs // n_ranks} envs each", flush=True)
    return launch(_train_rank, n_ranks, device.type, args.num_envs, args, run_dir)


def _train_rank(shard, args, run_dir: Path) -> dict:
    """One rank of ``train --n-devices``: its result without the TrainState."""
    out = _train_run(args, shard.device, run_dir, shard)
    return {**out, "ts": None, "iteration": out["ts"].iteration}


def _train_run(args, device, run_dir: Path, shard=None, on_iteration=None) -> dict:
    """Build the env and the trainer (a rank of a data-parallel run with
    ``shard``) and train; only rank 0 writes the run directory."""
    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.rl.checkpoint import Checkpointer, find_latest_run
    from learninghumanoidwalking_tpu_torch.rl.logger import TrainingLogger
    from learninghumanoidwalking_tpu_torch.rl.ppo import PPO, PPOConfig

    env = make_env(args.env, args.json, device=device)
    cfg = PPOConfig(
        n_itr=args.n_itr, lr=args.lr, eps=args.eps, gamma=args.gamma, lam=args.lam, std_dev=args.std_dev,
        learn_std=args.learn_std, entropy_coeff=args.entropy_coeff, clip=args.clip,
        minibatch_size=args.minibatch_size, epochs=args.epochs, num_envs=args.num_envs,
        rollout_len=args.rollout_len, max_traj_len=args.max_traj_len, max_grad_norm=args.max_grad_norm,
        mirror_coeff=args.mirror_coeff, use_mirror=not args.no_mirror, imitate_coeff=args.imitate_coeff,
        eval_freq=args.eval_freq, seed=args.seed, recurrent=args.recurrent,
    )

    projector = expert = None
    if args.imitate:
        from learninghumanoidwalking_tpu_torch.rl.eval import load_expert

        expert, _ = load_expert(Path(args.imitate), device=device)
        factory = getattr(env, "imitation_projector", None)
        projector = factory() if callable(factory) else None
        if projector is None:
            raise ValueError(f"--imitate passed but env {args.env} has no imitation_projector()")

    ppo = PPO(env, cfg, device=device, imitation_projector=projector, expert=expert, shard=shard)
    checkpointer = logger = None
    if ppo.lead:
        checkpointer = Checkpointer(run_dir)
        checkpointer.save_experiment({
            **vars(args), "env": args.env, "json": args.json, "obs_size": env.obs_size, "action_size": env.action_size,
            "net_dtype": cfg.net_dtype, "hidden": list(cfg.hidden),
        })
        logger = TrainingLogger(run_dir)  # log.jsonl (the JAX CLI writes TensorBoard events)

    init_ts = ppo.init_state()
    resumed = None
    if args.continued:
        resumed = find_latest_run(args.continued)
        if resumed is None:
            raise FileNotFoundError(f"no runs with checkpoints under {args.continued}")
        init_ts = Checkpointer(resumed).restore(init_ts, ppo.draws)
        if ppo.lead:
            print(f"resumed from {resumed} at iteration {init_ts.iteration}", flush=True)
    resumed_at = init_ts.iteration

    try:
        ts, history = ppo.train(args.n_itr, ts=init_ts, logger=logger, checkpointer=checkpointer,
                                profile_dir=args.profile_dir, on_iteration=on_iteration)
    finally:
        if logger is not None:
            logger.close()
    return dict(run_dir=run_dir, ts=ts, history=history, resumed_from=resumed, resumed_at=resumed_at)


def build_eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eval", description="Replay a trained policy (the JAX CLI's flags; see the differences noted per flag).")
    p.add_argument("--path", required=True, type=Path, help="run logdir (or parent of runs)")
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--max-steps", type=int, default=400)
    p.add_argument("--out", type=Path, default=None,
                   help="the trajectories' .npz, or a .gif / .mp4 video of episode 0 with its task markers (.mp4 needs an "
                        "ffmpeg writer for imageio)")
    p.add_argument("--deterministic", action="store_true", default=True)
    p.add_argument("--view", action="store_true", help="replay in a live MuJoCo window (needs a display)")
    p.add_argument("--no-realtime", action="store_true", help="with --view: do not pace the replay in real time")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu; cuda without a card is an error")
    return p


def evaluate(argv) -> dict:
    """Parse ``argv`` and replay; returns evaluate_policy's result."""
    args = build_eval_parser().parse_args(argv)
    device = resolve_device(args.device)
    system_banner(device)
    if args.view:
        from learninghumanoidwalking_tpu_torch.rl.viewer import view_policy

        return dict(loop=view_policy(args.path, episodes=args.episodes, max_steps=args.max_steps,
                                     realtime=not args.no_realtime, device=device))

    from learninghumanoidwalking_tpu_torch.rl.eval import evaluate_policy

    return evaluate_policy(args.path, episodes=args.episodes, max_steps=args.max_steps, out=args.out, device=device)


def main(argv) -> int:
    if len(argv) < 1 or argv[0] not in ("train", "eval"):
        print("usage: python -m learninghumanoidwalking_tpu_torch.run_experiment {train,eval} ...", file=sys.stderr)
        return 2
    (train if argv[0] == "train" else evaluate)(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
