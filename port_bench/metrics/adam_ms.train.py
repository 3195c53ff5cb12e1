"""Host ms per gradient step in the program's ppo.adam spans (its two
Adam.step calls, actor and critic) in the counted iterations."""

from port_bench.core import spans


def read(ctx):
    return spans.ms_per_span(ctx, "ppo.adam", per="ppo.grad_step")
