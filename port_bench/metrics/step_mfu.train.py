"""The whole iteration's share of the card's published peaks, percent: the
least time for the window's counted kernel and net work over its length."""

from port_bench.core import launches


def read(ctx):
    return launches.step_mfu(ctx)
