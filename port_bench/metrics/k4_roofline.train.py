"""K4 (the motor build, control_step_motor_kernel: steps at R=1 with the
motor nets): the launches' summed roofline bound over their summed device
time, percent."""

from port_bench.core import launches


def read(ctx):
    return launches.roofline(ctx, "control_step_motor_kernel")
