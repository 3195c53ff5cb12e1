"""Checkpoints of the port's trainer with torch.save (counterpart of
learninghumanoidwalking_tpu/rl/checkpoint.py, which uses Orbax).

A checkpoint is a self-contained dict of CPU tensors: the actor's and the
critic's state_dicts, both Adam states (``mu`` and ``nu`` by parameter
name, ``count``, ``notfinite_count``), the observation RunningNorm, the
state of the trainer's ``Draws`` generator (None where the draws have no
generator, as injected ones) and the iteration. The env batch is not kept:
a resumed run starts from fresh envs, as in the JAX package. Nor are a
recurrent policy's carries, which belong to the env batch: a resumed run
starts them at zero (the target's, from ``PPO.init_state``).

Layout under a run directory:
  checkpoints/<itr>.pt        a save at every evaluation
  checkpoints/metrics_<itr>.json  that evaluation's metrics
  best.pt                     the best save so far by eval reward
  experiment.json             the run's configuration and env name
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import torch

from learninghumanoidwalking_tpu_torch.rl.normalize import RunningNorm


def adam_state(opt, module: torch.nn.Module) -> dict:
    """An Adam's state with its moments keyed by the module's parameter names."""
    names = [n for n, _ in module.named_parameters()]
    return dict(
        mu=dict(zip(names, opt.mu)), nu=dict(zip(names, opt.nu)),
        count=opt.count, notfinite_count=opt.notfinite_count,
    )


def load_adam_state(opt, module: torch.nn.Module, state: dict) -> None:
    """Set an Adam (built over ``module``'s parameters) to a saved state."""
    dev = opt.count.device
    names = [n for n, _ in module.named_parameters()]
    opt.mu = [state["mu"][n].to(device=dev, dtype=torch.float32).clone() for n in names]
    opt.nu = [state["nu"][n].to(device=dev, dtype=torch.float32).clone() for n in names]
    opt.count = torch.as_tensor(state["count"], dtype=opt.count.dtype).to(dev).clone()
    opt.notfinite_count = torch.as_tensor(state["notfinite_count"], dtype=torch.int32).to(dev).clone()


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def persistable(ts, draws=None) -> dict:
    """What a checkpoint keeps of a TrainState (and the trainer's draws), on the CPU."""
    gen = getattr(draws, "gen", None)
    return _to_cpu(dict(
        actor=ts.actor.state_dict(),
        critic=ts.critic.state_dict(),
        actor_opt=adam_state(ts.actor_opt, ts.actor),
        critic_opt=adam_state(ts.critic_opt, ts.critic),
        norm=dict(mean=ts.norm.mean, var=ts.norm.var, count=ts.norm.count),
        generator=None if gen is None else gen.get_state(),
        iteration=int(ts.iteration),
    ))


def apply_persisted(target, state: dict, draws=None):
    """``target`` (a TrainState) with the persisted fields of ``state``
    loaded in place (parameters and Adam moments keep their tensors' device),
    the generator of ``draws`` set to the saved state where both have one,
    and the env batch's per-env iteration set to the restored iteration."""
    target.actor.load_state_dict(state["actor"])
    target.critic.load_state_dict(state["critic"])
    load_adam_state(target.actor_opt, target.actor, state["actor_opt"])
    load_adam_state(target.critic_opt, target.critic, state["critic_opt"])
    dev = target.norm.mean.device
    norm = RunningNorm(**{k: torch.as_tensor(v, dtype=torch.float32).to(dev).clone() for k, v in state["norm"].items()})
    gen = getattr(draws, "gen", None)
    if gen is not None and state.get("generator") is not None:
        gen.set_state(state["generator"])
    iteration = int(state["iteration"])
    env_state = target.env_state
    if env_state is not None:
        env_state = dataclasses.replace(env_state, iteration=torch.full_like(env_state.iteration, iteration))
    return dataclasses.replace(target, norm=norm, iteration=iteration, env_state=env_state)


class Checkpointer:
    def __init__(self, logdir: str | Path):
        self.logdir = Path(logdir)
        self.ckpt_dir = self.logdir / "checkpoints"
        self.best_path = self.logdir / "best.pt"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)

    def save_experiment(self, config: dict) -> None:
        with open(self.logdir / "experiment.json", "w") as f:
            json.dump(config, f, indent=2, default=str)

    @staticmethod
    def load_experiment(logdir: str | Path) -> dict:
        with open(Path(logdir) / "experiment.json") as f:
            return json.load(f)

    def path(self, itr: int) -> Path:
        return self.ckpt_dir / f"{itr}.pt"

    def save_state(self, itr: int, state: dict, metrics: dict | None = None, is_best: bool = False) -> None:
        """Write a persisted state (of ``persistable`` or rl/convert.py) as
        checkpoint ``itr``, through a temporary file and a rename."""
        path = self.path(itr)
        tmp = path.with_suffix(".pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        if metrics is not None:
            with open(self.ckpt_dir / f"metrics_{itr}.json", "w") as f:
                json.dump(metrics, f)
        if is_best:
            shutil.copyfile(path, self.best_path)

    def save(self, itr: int, ts, draws=None, metrics: dict | None = None, is_best: bool = False) -> None:
        self.save_state(itr, persistable(ts, draws), metrics, is_best)

    def latest_iteration(self) -> int | None:
        itrs = [int(p.stem) for p in self.ckpt_dir.iterdir() if p.suffix == ".pt" and p.stem.isdigit()]
        return max(itrs) if itrs else None

    def load(self, itr: int | None = None, best: bool = False) -> dict:
        """The persisted state of checkpoint ``itr`` (default the latest), or
        of best.pt."""
        if best:
            path = self.best_path
            if not path.exists():
                raise FileNotFoundError(f"no best checkpoint at {path}")
        else:
            itr = itr if itr is not None else self.latest_iteration()
            if itr is None:
                raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
            path = self.path(itr)
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, target, draws=None, itr: int | None = None, best: bool = False):
        """``target`` with the persisted fields of a checkpoint (see
        apply_persisted)."""
        return apply_persisted(target, self.load(itr, best), draws)


def _has_checkpoints(p: Path) -> bool:
    ck = p / "checkpoints"
    return ck.exists() and any(ck.iterdir())


def find_latest_run(base: str | Path) -> Path | None:
    """The latest run directory under ``base`` (or ``base`` itself). A run
    counts only if its checkpoints directory is non-empty (a crashed launch
    can leave an empty one behind)."""
    base = Path(base)
    if _has_checkpoints(base):
        return base
    runs = sorted([p for p in base.iterdir() if _has_checkpoints(p)]) if base.exists() else []
    return runs[-1] if runs else None
