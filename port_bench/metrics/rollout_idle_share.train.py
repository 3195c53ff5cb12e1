"""1 - the union of device activity inside the program's ppo.sample spans,
placed on the device timeline (port_bench/core/spans.py), over their summed
length, in the counted iterations."""

from port_bench.core import spans


def read(ctx):
    return spans.idle_share(ctx, "ppo.sample")
