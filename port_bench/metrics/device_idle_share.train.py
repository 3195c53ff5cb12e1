"""1 - the union of device activity over the window's length on the device
timeline (port_bench/core/trace.py's union)."""

from port_bench.core import trace


def read(ctx):
    tw = ctx["trace"]
    if tw is None:
        return None
    busy = trace.union_within([(e[2], e[3]) for it in tw["iterations"] for e in it], tw["lo"], tw["hi"])
    return 1.0 - busy / (tw["hi"] - tw["lo"])
