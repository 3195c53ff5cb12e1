"""Raw physics-kernel throughput (counterpart of scripts/bench_kernel.py):
control steps of K1 (25 substeps) on jvrc_walk, no policy, task or reset
in the loop, which isolates the kernel from the rollout around it.

Per batch size B: a seeded ``reset_batch``, targets of zeros, then ``n``
(default 32) control steps through ``ops/substep_kernel.py::
pd_substeps_kernel`` at the env's factorization-reuse interval, as training
steps it (the JAX script calls the Pallas kernel at its default R=1). One
warm call of the ``n`` steps first (it pays for the kernel build at first
use), then one timed call, the clock read after ``torch.cuda.synchronize()``.
Prints a first line with the env, the step count and R (the JAX script's
lines do not show R), then the JAX script's line per batch size:

    bench_kernel: jvrc_walk, 32 control steps of 25 substeps, factorization reuse R=5 (scripts/bench_kernel.py: R=1)
    B= 32768:      xxx,xxx env steps/s     xx.x ns/env-substep

  python -m learninghumanoidwalking_tpu_torch.bench_kernel [batches ...] [--steps N] [--device cuda|cpu]

Batch sizes default to 4096 8192 16384 32768. ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs the plain version
(physics/batched.py), for the tests only: its numbers are the CPU's.
"""

from __future__ import annotations

import argparse
import sys
import time

BATCHES = (4096, 8192, 16384, 32768)
STEPS = 32


def format_line(row: dict) -> str:
    """The JAX script's printed line (scripts/bench_kernel.py:58)."""
    return f"B={row['B']:6d}: {row['steps_per_s']:12,.0f} env steps/s   {row['ns_per_env_substep']:6.1f} ns/env-substep"


def run(batches, steps: int, device) -> list[dict]:
    """Time ``steps`` control steps at each batch size on ``device``,
    printing the first line, then each batch size's line as it is measured;
    one dict a batch size (B, env steps/s, ns an env-substep, ms a control
    step)."""
    import torch

    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.ops.substep_kernel import pd_substeps_kernel
    from learninghumanoidwalking_tpu_torch.perf_probe import sync
    from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

    env = make_env("jvrc_walk", device=device)
    model = env.model
    print(f"bench_kernel: jvrc_walk, {steps} control steps of {env.frame_skip} substeps, factorization reuse "
          f"R={env.physics_reuse} (scripts/bench_kernel.py: R=1)", flush=True)
    rows = []
    for batch in batches:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        states = env.reset_batch(batch, Draws(gen))
        target = torch.zeros((batch, model.nu), device=device)

        def rollout():
            physics = states.physics
            for _ in range(steps):
                physics = pd_substeps_kernel(model, states.dyn, physics, target, env.frame_skip, env.sim_dt,
                                             reuse_interval=env.physics_reuse)
            return physics

        rollout()
        sync(device)
        t0 = time.perf_counter()
        rollout()
        sync(device)
        dt = time.perf_counter() - t0
        row = dict(B=batch, steps_per_s=batch * steps / dt, ns_per_env_substep=dt / (batch * steps * env.frame_skip) * 1e9,
                   ms_per_step=1e3 * dt / steps)
        print(format_line(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    from learninghumanoidwalking_tpu_torch.run_experiment import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batches", nargs="*", type=int, default=list(BATCHES))
    p.add_argument("--steps", type=int, default=STEPS, help="control steps a timed call")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.batches, args.steps, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
