"""Curved footstep plan generation.

Copy of learninghumanoidwalking_tpu/utils/footstep_plans.py for the port
(numpy only; no import of the JAX package). The JAX docstring follows.

The reference ships a static bank of pre-generated curved footstep sequences
(reference utils/footstep_plans.txt: "---"-separated (x, y, theta)
lines) consumed by the stepping task's CURVED mode
(reference tasks/stepping_task.py:52-64). Here the bank is generated
procedurally at build time with a fixed seed, tuned to the shipped bank's
measured distribution (the JAX package's tests/test_footstep_plans.py asserts the match):

  - 7-18 footholds per plan (shipped: mean 12.9, range [7, 18]);
  - strides mostly 0.24-0.34 m (shipped: mean 0.287, std 0.061) with an
    occasional short correction step supplying the shipped bank's 0.14 m
    5th-percentile tail;
  - heading changes are DISCRETE turn events quantized to multiples of pi/16
    (the shipped plans' thetas are exact multiples of 0.19635): ~59% of
    steps keep heading, turns are 1-3.5 x pi/16 in either direction.

Plans are padded to a fixed (n_plans, max_steps, 4) array ([x, y, z, theta],
z = 0 for curved plans) + per-plan lengths so CURVED-mode resets are a single
gather.
"""

from __future__ import annotations

import numpy as np

MAX_STEPS = 24

_TURN_QUANTUM = np.pi / 16.0


def generate_plan(rng: np.random.Generator, n_steps: int) -> np.ndarray:
    """One curved plan: (n_steps, 3) of (x, y, theta)."""
    step_len = rng.uniform(0.24, 0.33)
    half_width = rng.uniform(0.06, 0.08)
    pos = np.zeros(2)
    heading = 0.0
    # first foothold directly right of origin (plans start with (0, -0.07, 0))
    steps = [np.array([0.0, -0.07, 0.0])]
    side = 1.0  # next step left
    for i in range(1, n_steps):
        if i == n_steps - 1:
            # end-of-plan correction step: a short hop landing near the
            # previous foothold with a non-quantized heading tweak (the
            # shipped plans end with exactly one such adjustment step,
            # e.g. 0.146 m at the end of the first shipped plan)
            heading += rng.uniform(-0.35, 0.35)
            prev = steps[-1][:2]
            hop = rng.uniform(0.10, 0.18)
            ang = heading + rng.uniform(-np.pi, np.pi)
            foot = prev + hop * np.array([np.cos(ang), np.sin(ang)])
            steps.append(np.array([foot[0], foot[1], heading]))
            break
        if rng.uniform() < 0.33:
            # discrete quantized turn event
            quanta = rng.integers(2, 8)  # 1.0 .. 3.5 x pi/16
            heading += rng.choice([-1.0, 1.0]) * quanta * _TURN_QUANTUM / 2.0
        pos = pos + step_len / 2.0 * np.array([np.cos(heading), np.sin(heading)])
        normal = np.array([-np.sin(heading), np.cos(heading)])
        foot = pos + side * half_width * 2.0 * normal
        steps.append(np.array([foot[0], foot[1], heading]))
        side = -side
    return np.stack(steps)


def plan_bank(n_plans: int = 40, seed: int = 1234) -> tuple[np.ndarray, np.ndarray]:
    """(n_plans, MAX_STEPS, 4) padded [x, y, z=0, theta] + (n_plans,) lengths."""
    rng = np.random.default_rng(seed)
    bank = np.zeros((n_plans, MAX_STEPS, 4), dtype=np.float32)
    lengths = np.zeros(n_plans, dtype=np.int32)
    for p in range(n_plans):
        # shipped bank: 7-18 footholds per plan, mean 12.9
        n = int(rng.integers(7, 19))
        plan = generate_plan(rng, n)
        bank[p, :n, 0] = plan[:, 0]
        bank[p, :n, 1] = plan[:, 1]
        bank[p, :n, 3] = plan[:, 2]
        # pad with the last step so out-of-range gathers are benign
        bank[p, n:] = bank[p, n - 1]
        lengths[p] = n
    return bank, lengths
