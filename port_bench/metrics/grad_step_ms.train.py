"""Mean host ms of the program's ppo.grad_step spans (one gradient step of
both nets: loss, backward, both Adam steps) in the counted iterations."""

from port_bench.core import spans


def read(ctx):
    return spans.ms_per_span(ctx, "ppo.grad_step")
