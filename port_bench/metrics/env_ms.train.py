"""Host ms per counted iteration in the program's env.step and env.reset
spans, less their physics.launch children: the env's own host work around
the physics (port_bench/core/spans.py)."""

from port_bench.core import spans


def read(ctx):
    return spans.ms_per_iteration(ctx, ("env.step", "env.reset"), less="physics.launch")
