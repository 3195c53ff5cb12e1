"""Device kernels, memory copies and memory sets per iteration of the window
(the trace's device events, the window's markers left out)."""


def read(ctx):
    tw = ctx["trace"]
    if tw is None:
        return None
    return sum(len(it) for it in tw["iterations"]) / len(tw["iterations"])
