"""Blocking host-device synchronizations the program counted per counted
iteration (torch.cuda's sync debug mode, charged to its spans)."""

from port_bench.core import spans


def read(ctx):
    return spans.syncs_per_iteration(ctx)
