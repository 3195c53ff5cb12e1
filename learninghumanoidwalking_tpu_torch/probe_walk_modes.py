"""Walk-mode probe (counterpart of scripts/probe_walk_modes.py).

Loads a trained feed-forward run (jvrc_walk, h1_walk or jvrc_walk_rough),
forces each walking mode (FORWARD, INPLACE, STANDING) with a fixed velocity
reference, rolls the deterministic policy on the envs' engine path
(``HumanoidEnv.reset``/``step``: no kernel, as the JAX script's single-env
``env.step``) and prints, per mode, the root's displacement and velocity,
its turn rate, its height and the reward per step: the commanded-velocity
tracking numbers PERFORMANCE.md quotes.

The three modes run as one batch of three rows from one reset, each row
drawing what a single env seeded 7 draws (``utils/seeding.py::HostDraws``,
one row drawn and broadcast), so the lines equal those of the modes run
in turn. A row that terminates stops counting; the others go on. The JAX
script's quirks are kept (ROADMAP reference behaviour 17): the start
position and yaw are read after step 0, not at the reset; the elapsed time
is (t + 1) control steps; the yaw difference is wrapped to [-pi, pi).

  python -m learninghumanoidwalking_tpu_torch.probe_walk_modes --path <run> [--steps 160] [--device cuda|cpu]

``--device`` defaults to ``cuda``; without a card that raises, as the
port's command line does (pass ``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
from pathlib import Path

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.physics.model import tree_map
from learninghumanoidwalking_tpu_torch.tasks import walking
from learninghumanoidwalking_tpu_torch.utils.seeding import Draws, HostDraws

SEED = 7


class BroadcastDraws(Draws):
    """Every per-env draw of ``n`` rows drawn for one row from ``inner`` and
    repeated: n envs see the numbers one env of ``inner`` would see."""

    def __init__(self, inner: Draws, n: int):
        self.inner, self.n = inner, n

    def _rows(self, shape, fn):
        if shape[0] != self.n:
            raise ValueError(f"a draw of shape {tuple(shape)} for {self.n} rows")
        x = fn((1,) + tuple(shape[1:]))
        return x.expand(tuple(shape)).clone()

    def uniform(self, name, shape, lo, hi, device):
        return self._rows(shape, lambda s: self.inner.uniform(name, s, lo, hi, device))

    def randint(self, name, shape, lo, hi, device):
        return self._rows(shape, lambda s: self.inner.randint(name, s, lo, hi, device))

    def normal(self, name, shape, device):
        return self._rows(shape, lambda s: self.inner.normal(name, s, device))

    def choice(self, name, shape, values, p, device):
        return self._rows(shape, lambda s: self.inner.choice(name, s, values, p, device))

    def permutation(self, name, n, device):
        raise NotImplementedError("a permutation is not per env")


def probes(vx: float, yaw_rate: float) -> list:
    """(name, mode code, velocity reference [yaw_vel, vx, vy]) per mode, in the JAX script's order."""
    return [
        ("FORWARD", walking.FORWARD, (0.0, vx, 0.0)),
        ("INPLACE", walking.INPLACE, (yaw_rate, 0.0, 0.0)),
        ("STANDING", walking.STANDING, (0.0, 0.0, 0.0)),
    ]


def _force(state, mode, mode_ref):
    """``state`` with its walking task's mode and reference replaced (inside
    RoughWalkState.walk on jvrc_walk_rough)."""
    task = state.task
    if hasattr(task, "walk"):
        task = dataclasses.replace(task, walk=dataclasses.replace(task.walk, mode=mode, mode_ref=mode_ref))
    else:
        task = dataclasses.replace(task, mode=mode, mode_ref=mode_ref)
    return dataclasses.replace(state, task=task)


def _rows(state, n: int):
    """A one-env state repeated into ``n`` rows."""
    return tree_map(lambda x: x.expand((n,) + tuple(x.shape[1:])).clone() if torch.is_tensor(x) and x.dim() else x, state)


def probe(path, steps: int = 160, vx: float = 0.3, yaw_rate: float = 0.4, device="cuda", draws=None,
          modes: tuple | None = None) -> list:
    """Probe the run at ``path`` in each of ``modes`` (default all three, in
    the JAX script's order) for at most ``steps`` control steps, as one
    batch; print the JAX script's lines and return them. ``draws``: a Draws
    source of one env for the reset and every step, or a sequence of them
    (the reset's, then one a control step); by default a HostDraws seeded 7."""
    from learninghumanoidwalking_tpu_torch.rl.eval import RecurrentPolicy, load_policy
    from learninghumanoidwalking_tpu_torch.run_experiment import resolve_device
    from learninghumanoidwalking_tpu_torch.utils import maths

    dev = resolve_device(str(device))
    policy, _, (env, _) = load_policy(Path(path), device=dev)
    if isinstance(policy, RecurrentPolicy):
        raise SystemExit("recurrent probe not supported; use a FF run")
    table = [p for p in probes(vx, yaw_rate) if modes is None or p[0] in modes]
    n = len(table)
    if draws is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(SEED)
        draws = HostDraws(gen)
    calls = iter(draws) if isinstance(draws, (list, tuple)) else itertools.repeat(draws)
    mode = torch.tensor([m for _, m, _ in table], dtype=torch.int64, device=dev)
    mode_ref = torch.tensor([r for _, _, r in table], dtype=torch.float32, device=dev)

    state = _force(_rows(env.reset(1, next(calls)), n), mode, mode_ref)
    alive = [True] * n
    total_r = [0.0] * n
    last_t = [steps - 1] * n
    p0, yaw0, p1, yaw1, height = [None] * n, [None] * n, [None] * n, [None] * n, [None] * n
    lines: list[list[str]] = [[] for _ in range(n)]
    for t in range(steps):
        state = env.step(state, policy(state.obs), BroadcastDraws(next(calls), n))
        state = _force(state, mode, mode_ref)
        reward = state.reward.tolist()
        done = state.done.tolist()
        qpos = state.physics.qpos.cpu().numpy()
        yaw = maths.quat_to_rpy(state.physics.qpos[:, 3:7])[:, 2].tolist()
        for i in range(n):
            if not alive[i]:
                continue
            total_r[i] += reward[i]
            if t == 0:
                p0[i], yaw0[i] = qpos[i, :2], yaw[i]
            p1[i], yaw1[i], height[i] = qpos[i, :2], yaw[i], float(qpos[i, 2])
            if done[i]:
                lines[i].append(f"{table[i][0]}: terminated at step {t}")
                alive[i], last_t[i] = False, t
        if not any(alive):
            break
    out = []
    for i, (name, _, ref) in enumerate(table):
        t = last_t[i]
        dt = (t + 1) * env.control_dt
        disp = p1[i] - p0[i]
        dyaw = (yaw1[i] - yaw0[i] + np.pi) % (2 * np.pi) - np.pi
        lines[i].append(
            f"{name:9s} ref={ref}: root moved ({disp[0]:+.3f}, {disp[1]:+.3f}) m in {dt:.1f} s "
            f"-> v=({disp[0] / dt:+.3f}, {disp[1] / dt:+.3f}) m/s, yaw_rate={dyaw / dt:+.3f} rad/s, "
            f"height={height[i]:.3f} m, reward/step={total_r[i] / (t + 1):.3f}"
        )
        for line in lines[i]:
            print(line, flush=True)
        out.extend(lines[i])
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", type=Path, required=True)
    ap.add_argument("--steps", type=int, default=160)  # 4 s at 40 Hz
    ap.add_argument("--vx", type=float, default=0.3)
    ap.add_argument("--yaw-rate", type=float, default=0.4)
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu; cuda without a card is an error")
    args = ap.parse_args(argv)
    return probe(args.path, args.steps, args.vx, args.yaw_rate, args.device)


if __name__ == "__main__":
    main()
