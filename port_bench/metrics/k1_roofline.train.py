"""K1 (the flat build, control_step_flat_kernel: steps at R=5 and settles):
the launches' summed roofline bound over their summed device time, percent."""

from port_bench.core import launches


def read(ctx):
    return launches.roofline(ctx, "control_step_flat_kernel")
