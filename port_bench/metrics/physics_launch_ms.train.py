"""Host ms per counted iteration in the program's physics.launch spans (the
whole of pd_substeps_kernel: layouts, tables, the launch call)."""

from port_bench.core import spans


def read(ctx):
    return spans.ms_per_iteration(ctx, ("physics.launch",))
